"""Level-of-detail construction + nearest-neighbour prediction search.

Counterpart of the reference's LoD machinery (`AttributeLods::generate`
AttributeCommon.cpp:46, subsampling dispatch PCCTMC3Common.h:2223-2252,
3-NN search `computeNearestNeighbors` PCCTMC3Common.h:1148-1955).

TPU-first redesign:
* LoD assignment is **periodic decimation in Morton order** (the
  reference's `lodSamplingPeriod` scheme, PCCTMC3Common.h:2223): level
  membership is a pure function of the point's rank in Morton order, so
  encoder and decoder derive it with zero signalling.
* The 3-NN search replaces the reference's 27-cell Morton atlas +
  BoxHierarchy pruning with a **Morton-window candidate search**: the
  W predecessors/successors of the query's insertion point in the
  sorted reference set are the candidates; the 3 closest by true
  squared distance win (ties -> lower Morton rank).  This is a gather
  of a fixed window per point — fully vectorisable.
* Prediction weights are fixed-point Q16 inverse-squared-distance
  (reference PCCPredictor weight derivation, PCCTMC3Common.h:521-634),
  making encoder/decoder prediction bit-identical on any backend.

All functions are deterministic functions of (positions in coding
order) only — both codec sides call them identically.
"""

from __future__ import annotations

import numpy as np

from ..utils import morton

W_FRAC_BITS = 16
W_ONE = 1 << W_FRAC_BITS


def estimate_dist2(positions: np.ndarray, sampling_period: int = 100,
                   search_range: int = 128,
                   percentile: float = 0.85) -> int:
    """Slice dist2 estimation (reference estimateDist2,
    AttributeEncoder.cpp:1685): sample every `sampling_period`-th
    point, find its min squared distance within +-search_range array
    positions, take the `percentile` value, and snap up to the
    3·4^s law.  Returns the squared distance 3 << 2s (the reference
    signals the shift s; our APS carries the raw value)."""
    n = positions.shape[0]
    if n < 2:
        return 0
    p = positions.astype(np.int64)
    idx = np.arange(0, n, sampling_period, dtype=np.int64)
    offs = np.arange(-search_range, search_range + 1, dtype=np.int64)
    cand = idx[:, None] + offs[None, :]
    ok = (cand >= 0) & (cand < n) & (offs[None, :] != 0)
    cand = np.clip(cand, 0, n - 1)
    d = p[cand] - p[idx][:, None, :]
    d2 = np.einsum("ijk,ijk->ij", d, d)
    d2 = np.where(ok, d2, np.int64(2 ** 62))
    mins = d2.min(axis=1)
    k = int(np.floor(mins.shape[0] * percentile))
    k = min(k, mins.shape[0] - 1)
    dist2 = int(np.partition(mins, k)[k])
    s = 0
    while (3 << (2 * s)) < dist2 and s < 20:
        s += 1
    return 3 << (2 * s)


def assign_lod_levels_dist2(positions: np.ndarray, num_levels: int,
                            dist2_base: int) -> np.ndarray:
    """Distance-based LoD (reference subsampleByDistance): greedy
    retain-if-isolated walk in Morton order with dist2 quartering per
    level.  Native serial pass (lod.cc); falls back to a pure-python
    walk for small inputs."""
    from mpeg_pcc_tmc13_tpu.bitstream import entropy
    n = positions.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    if entropy._LIB is not None:
        import ctypes
        xyz = np.ascontiguousarray(positions, dtype=np.int64)
        out = np.zeros(n, dtype=np.uint8)
        entropy._LIB.lod_assign_dist2(
            xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            int(dist2_base), int(num_levels),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.astype(np.int32)
    # python fallback (exact mirror)
    levels = np.full(n, num_levels - 1, dtype=np.int32)
    assigned = np.zeros(n, dtype=bool)
    retained: list = []
    d2 = dist2_base
    p = positions.astype(np.int64)
    for l in range(num_levels - 1):
        if d2 <= 0:
            break
        for i in range(n):
            if assigned[i]:
                continue
            ok = True
            for j in retained:
                d = p[i] - p[j]
                if int(d @ d) < d2:
                    ok = False
                    break
            if ok:
                levels[i] = l
                assigned[i] = True
                retained.append(i)
        d2 >>= 2
    return levels


def assign_lod_levels(n: int, num_levels: int, period: int = 4):
    """Level id per Morton-ranked point (0 = coarsest).

    Point with rank divisible by period**k (k maximal) sits k levels
    above the finest; capped at num_levels-1.
    """
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    ranks = np.arange(n, dtype=np.int64)
    level = np.full(n, num_levels - 1, dtype=np.int32)
    step = period
    for k in range(1, num_levels):
        level[ranks % step == 0] = num_levels - 1 - k
        step *= period
    return level


def lod_order(levels: np.ndarray) -> np.ndarray:
    """Coding order of attributes: coarsest level first, Morton order
    within a level.  Returns indices into the Morton-ordered arrays."""
    return np.argsort(levels, kind="stable")


def knn_predictors(positions: np.ndarray, levels: np.ndarray,
                   num_neighbors: int = 3, window: int = 8,
                   ref_positions: np.ndarray = None,
                   intra_lod0: bool = False):
    """Per point: up to 3 neighbour indices + Q16 weights.

    positions: (N,3) int, Morton coding order. levels: (N,) LoD ids.
    Neighbour candidates for a point at level l are points of levels
    < l.  With intra_lod0, level-0 points additionally predict from
    preceding level-0 points (reference intraLodPredictionSkipLayers;
    the DEFAULT disables intra-LoD prediction, TMC3.cpp:1394-1397, and
    the lifting transform forces it off, TMC3.cpp:1878 — an intra
    chain would cascade the lifting quantisation weights without
    bound).

    ref_positions: optional (M,3) motion-compensated reference-frame
    points (inter attribute prediction, reference
    AttributeInterPredParams): they join every level's candidate set
    (including level 0, whose intra chain is then dropped).  Returned
    neighbour indices are then into the AUGMENTED array
    [ref_positions; positions] — i.e. index < M means reference row.

    Returns (nbr_idx (N,k) int64 [-1 = unused], weights_q16 (N,k)).
    """
    n = positions.shape[0]
    k = num_neighbors
    nbr = np.full((n, k), -1, dtype=np.int64)
    wq = np.zeros((n, k), dtype=np.int64)
    if n == 0:
        return nbr, wq
    m = 0 if ref_positions is None else ref_positions.shape[0]
    if m:
        # reference rows act as a permanent coarsest level (-1)
        aug_pos = np.concatenate(
            [ref_positions.astype(np.int64), positions.astype(np.int64)])
        aug_levels = np.concatenate(
            [np.full(m, -1, dtype=levels.dtype), levels])
        codes = morton.encode(aug_pos)
        positions = aug_pos
    else:
        aug_levels = levels
        codes = morton.encode(positions.astype(np.int64))
        positions = positions.astype(np.int64)
    num_levels = int(levels.max()) + 1 if n else 0

    # one global code sort; every level's candidate set is a filtered
    # subset of it (a stable filter of a stably-sorted array equals
    # the per-level stable sort the spec describes)
    order_all = np.argsort(codes, kind="stable")
    lev_sorted = aug_levels[order_all]

    from mpeg_pcc_tmc13_tpu.bitstream import entropy as _ent
    native = _ent._LIB is not None
    if native:
        import ctypes as _ct
        _lib = _ent._LIB
        if not hasattr(_lib.lod_knn_topk, "_configured"):
            _lib.lod_knn_topk.argtypes = [_ct.POINTER(_ct.c_int64)] * 3 \
                + [_ct.c_int64] + [_ct.POINTER(_ct.c_int64)] * 2 \
                + [_ct.c_int64, _ct.POINTER(_ct.c_int64), _ct.c_int,
                   _ct.c_int, _ct.POINTER(_ct.c_int64),
                   _ct.POINTER(_ct.c_int64)]
            _lib.lod_knn_topk._configured = True

    for l in range(num_levels):
        q_idx = m + np.nonzero(levels == l)[0]
        if l == 0 and not m:
            if not intra_lod0:
                continue        # level 0 codes raw (reference default)
            # intra-level: predict from preceding level-0 points
            r_idx = q_idx[np.argsort(codes[q_idx], kind="stable")]
            intra = True
        else:
            r_idx = order_all[lev_sorted < l]
            intra = False
        if q_idx.size == 0 or r_idx.size == 0:
            continue
        r_codes = codes[r_idx]
        pos_r = positions[r_idx].astype(np.int64)
        if native:
            import ctypes as _ct
            own = None
            if intra:
                own = np.ascontiguousarray(
                    np.searchsorted(r_idx, q_idx), dtype=np.int64)
            rc = np.ascontiguousarray(r_codes)
            rp = np.ascontiguousarray(pos_r)
            rm = np.ascontiguousarray(r_idx, dtype=np.int64)
            qc = np.ascontiguousarray(codes[q_idx])
            qp = np.ascontiguousarray(positions[q_idx], dtype=np.int64)
            nbr_l = np.empty((q_idx.size, k), dtype=np.int64)
            w_l = np.empty((q_idx.size, k), dtype=np.int64)
            p = lambda a: a.ctypes.data_as(_ct.POINTER(_ct.c_int64))
            _lib.lod_knn_topk(
                p(rc), p(rp), p(rm), r_idx.size, p(qc), p(qp),
                q_idx.size,
                p(own) if own is not None else None, k, window,
                p(nbr_l), p(w_l))
            nbr[q_idx - m] = nbr_l
            wq[q_idx - m] = w_l
            continue
        ins = np.searchsorted(r_codes, codes[q_idx])
        # window of candidate ranks around the insertion point
        # (ascending within each row, so a stable sort on distance
        # breaks ties toward the lower Morton rank)
        offs = np.arange(-window, window, dtype=np.int64)
        cand = ins[:, None] + offs[None, :]
        np.clip(cand, 0, r_idx.size - 1, out=cand)
        # clip repeats edge ranks; mark duplicates (adjacent compare)
        dup = np.concatenate(
            [np.zeros((cand.shape[0], 1), bool),
             cand[:, 1:] == cand[:, :-1]], axis=1)
        if intra:
            # only strictly-preceding points are decodable predictors
            own_rank = np.searchsorted(r_idx, q_idx)
            valid = (cand < own_rank[:, None]) & ~dup
        else:
            valid = ~dup
        d = pos_r[cand] - positions[q_idx][:, None, :]
        d2 = np.sum(d * d, axis=-1)
        big = np.int64(1) << 60
        d2 = np.where(valid, d2, big)

        top = np.argsort(d2, kind="stable", axis=1)[:, :k]
        top_d2 = np.take_along_axis(d2, top, axis=1)
        top_cand = np.take_along_axis(cand, top, axis=1)
        ok = top_d2 < big
        nbr_l = np.where(ok, r_idx[top_cand], -1)
        # Q16 inverse-d2 weights, normalised over valid neighbours;
        # an exact positional match (d2 == 0, only possible for
        # reference-frame candidates) dominates at 4x the d2=1 weight
        inv = np.where(
            ok, 1.0 / np.maximum(top_d2.astype(np.float64), 0.25), 0.0)
        s = inv.sum(axis=1, keepdims=True)
        s[s == 0] = 1.0
        w = np.floor(inv / s * W_ONE + 0.5).astype(np.int64)
        nbr[q_idx - m] = nbr_l
        wq[q_idx - m] = w
    return nbr, wq


def predict_q16(values: np.ndarray, nbr: np.ndarray,
                wq: np.ndarray) -> np.ndarray:
    """Weighted prediction round((sum w*a) / 2^16) per point, integer.

    values (N,C) int64 — the *reconstructed* attribute values of
    neighbour points must already be final when a point is predicted
    (callers process in LoD order).
    """
    m, c = nbr.shape[0], values.shape[1]
    pred = np.zeros((m, c), dtype=np.int64)
    mask = nbr >= 0
    idx = np.where(mask, nbr, 0)
    vals = values[idx]                       # (N,k,C)
    acc = np.sum(vals * wq[:, :, None], axis=1)
    has = mask.any(axis=1)
    pred[has] = (acc[has] + (W_ONE // 2)) >> W_FRAC_BITS
    return pred
