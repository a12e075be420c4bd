"""Predicting & lifting attribute transforms over LoD structure.

Counterpart of the reference's predicting transform
(`encodeColorsPred/encodeReflectancesPred`, AttributeEncoder.cpp:594,515)
and lifting transform (`PCCLiftPredict/PCCLiftUpdate`,
PCCTMC3Common.h:718,776; `computeQuantizationWeights` :859).

Structure (all geometry-derived, zero side information):
  * LoD levels by Morton-rank decimation (ops/lod.py),
  * per-point <=3 NN predictors with Q16 inverse-d2 weights,
  * PRED: residual = value - weighted-NN(reconstructed), coded
    coarse->fine; the coarsest level chains on its own already-coded
    points (reference intra-LoD prediction),
  * LIFT: predict step (details) + update step (coarse correction)
    with popularity-derived quantisation weights; exactly invertible
    because the update uses only coded details.

qp==4 (step 1) with PRED is exactly lossless.
"""

from __future__ import annotations

import os

import numpy as np

from mpeg_pcc_tmc13_tpu.bitstream import entropy
from mpeg_pcc_tmc13_tpu.bitstream.hls import (AttributeDescription,
                                              AttributeEncoding,
                                              AttributeParameterSet)

from ..ops import lod as lod_ops
from .attributes import AttributeContexts, RES_CTX_SIZE, _RES_PREFIX_MAX, \
    _RES_K
from .attr_raht import (_lcp_estimate, _lcp_pred, _step_fn,
                        step_q16_vec)

_LOD_PERIOD = 4


def _num_levels(n: int, aps: AttributeParameterSet) -> int:
    auto = max(1, int(np.ceil(np.log(max(n, 2)) / np.log(_LOD_PERIOD))))
    return max(1, min(aps.lod_levels or auto, auto))


def _quant(res: np.ndarray, step_q16: int, factor_q8=None) -> np.ndarray:
    r = res.astype(np.float64)
    if factor_q8 is not None:
        r = r * (factor_q8[:, None] / 256.0)
    return np.round(r * 65536.0 / step_q16).astype(np.int64)


def _dequant(q: np.ndarray, step_q16: int, factor_q8=None) -> np.ndarray:
    d = q.astype(np.float64) * (step_q16 / 65536.0)
    if factor_q8 is not None:
        d = d / (factor_q8[:, None] / 256.0)
    return np.round(d).astype(np.int64)


def _structure(positions: np.ndarray, aps: AttributeParameterSet,
               ref_positions: np.ndarray = None):
    n = positions.shape[0]
    nl = _num_levels(n, aps)
    if aps.dist2 > 0 and aps.lod_decimation == 0:
        # aps.dist2 is the FINEST inter-level spacing (the slice
        # estimate); coarser levels double the spacing, mirroring the
        # reference's shiftBits = dist2 + lodIndex law
        # (PCCTMC3Common.h:2246).  Level 0 (coarsest) therefore uses
        # dist2 << 2*(nl-2).
        base = aps.dist2 << max(0, 2 * (nl - 2))
        levels = lod_ops.assign_lod_levels_dist2(positions, nl, base)
    else:
        levels = lod_ops.assign_lod_levels(n, nl, aps.lod_sampling_period)
    nbr, wq = lod_ops.knn_predictors(
        positions, levels, num_neighbors=aps.num_pred_nearest_neighbours,
        ref_positions=ref_positions)
    return levels, nbr, wq, nl


def _lift_quant_weights(levels: np.ndarray, nbr: np.ndarray,
                        wq: np.ndarray, n_ref: int = 0):
    """Recursive mass-conserving quantisation weights for the lifting
    transform (reference PCCComputeQuantizationWeights,
    PCCTMC3Common.h:828): every point starts at Q8 1.0; sweeping
    finest-to-coarsest, each point distributes its whole weight to its
    predictors in proportion to the PREDICTION weights.  Coarse points
    therefore accumulate their entire prediction subtree's mass, and
    scaling coefficients by sqrt(weight) gives them correspondingly
    finer effective steps — this is what holds base-layer quality at
    coarse QPs.  Returns (w_q8, factor_q8 = sqrt-scale)."""
    n = levels.shape[0]
    w = np.full(n, 256, dtype=np.int64)
    k = nbr.shape[1]
    nl = int(levels.max()) + 1 if n else 1
    # levels > 0: neighbours are strictly coarser, so per-level batches
    # reproduce the reference's reverse-index sweep exactly
    for lvl in range(nl - 1, 0, -1):
        sel = np.flatnonzero(levels == lvl)
        for j in range(k):
            t = nbr[sel, j] - n_ref      # inter-reference rows < 0
            ok = t >= 0
            if ok.any():
                contrib = (wq[sel[ok], j] * w[sel[ok]]
                           + (1 << 15)) >> 16
                np.add.at(w, t[ok], contrib)
    # level 0 predicts from preceding level-0 points: sequential
    # reverse sweep (the coarsest level is small)
    sel0 = np.flatnonzero(levels == 0)
    for i in sel0[::-1]:
        wi = w[i]
        for j in range(k):
            t = nbr[i, j] - n_ref
            if t >= 0:
                w[t] += (wq[i, j] * wi + (1 << 15)) >> 16
    factor = np.floor(np.sqrt(w.astype(np.float64) * 256.0)
                      + 0.5).astype(np.int64)
    return w, factor


def _lift_update(dq: np.ndarray, nbr_sel: np.ndarray,
                 wq_sel: np.ndarray, qw8_sel: np.ndarray,
                 shape, ncomp: int) -> np.ndarray:
    """Lifting update operator (reference PCCLiftUpdate,
    PCCTMC3Common.h:776): each coarse point receives the weighted MEAN
    of the details predicting from it, with per-edge weight
    predWeight·detailQuantWeight — bounded smoothing, unlike a raw
    accumulation.  dq: (m, C) dequantised details of the current
    level; qw8_sel: their Q8 quant weights."""
    num = np.zeros(shape, dtype=np.float64)
    den = np.zeros(shape[0], dtype=np.float64)
    valid = nbr_sel >= 0
    uw = ((wq_sel * qw8_sel[:, None]) + (1 << 15)) >> 16   # Q8
    uw = np.where(valid, uw, 0).astype(np.float64)
    idx = np.where(valid, nbr_sel, 0)
    flat_idx = idx.reshape(-1)
    flat_uw = uw.reshape(-1)
    contrib = uw[:, :, None] * dq[:, None, :].astype(np.float64)
    np.add.at(num, flat_idx, contrib.reshape(-1, ncomp))
    np.add.at(den, flat_idx, flat_uw)
    upd = np.zeros(shape, dtype=np.int64)
    nz = den > 0
    upd[nz] = np.floor(num[nz] / den[nz, None] + 0.5).astype(np.int64)
    return upd


def _icp_pred(c: int, dq0: np.ndarray) -> np.ndarray:
    """Reference ICP rounding: (coeff * luma_residual + 2) >> 2."""
    return (np.int64(c) * dq0.astype(np.int64) + 2) >> 2


def _region_offsets(positions, abh):
    """(n,2) per-point (luma, chroma) QP offsets from the ABH's region
    boxes (reference QpRegion, hls.h:953); first matching box wins.
    None when no regions are signalled."""
    if abh is None or not getattr(abh, "qp_regions", None):
        return None
    n = positions.shape[0]
    off = np.zeros((n, 2), dtype=np.int64)
    unset = np.ones(n, dtype=bool)
    p = positions.astype(np.int64)
    for origin, size, offs in abh.qp_regions:
        o = np.asarray(origin, dtype=np.int64)
        sz = np.asarray(size, dtype=np.int64)
        inside = np.all((p >= o) & (p < o + sz), axis=1) & unset
        off[inside] = offs
        unset &= ~inside
    return off


def _mode_eligible(recon, nbr, wq, threshold):
    """Per-point explicit-mode eligibility (reference predModeEligible,
    AttributeCommon.h:112-126): >=2 valid neighbours whose
    reconstructed values differ by more than the adaptive threshold.
    Both sides compute this from reconstructed values only."""
    valid = nbr >= 0
    nvalid = valid.sum(axis=1)
    idx = np.where(valid, nbr, 0)
    nv = recon[idx]                                  # (M,k,C)
    big = np.int64(1) << 40
    vmax = np.where(valid[:, :, None], nv, -big).max(axis=1)
    vmin = np.where(valid[:, :, None], nv, big).min(axis=1)
    maxdiff = (vmax - vmin).sum(axis=1)
    return (nvalid >= 2) & (maxdiff > threshold)


def _predict_with_modes(recon, nbr, wq, modes):
    """mode 0 = Q16 weighted average; mode j>0 = neighbour j-1."""
    pred = lod_ops.predict_q16(recon, nbr, wq)
    for j in range(nbr.shape[1]):
        sel = modes == (j + 1)
        if sel.any():
            pred[sel] = recon[np.maximum(nbr[sel, j], 0)]
    return pred


def encode(values: np.ndarray, positions: np.ndarray,
           aps: AttributeParameterSet, desc: AttributeDescription,
           ctx: AttributeContexts, ref=None, abh=None) -> bytes:
    """ref: optional (ref_positions (M,3), ref_values (M,C)) —
    motion-compensated reference-frame points in slice-local coords
    with their decoded attribute values (inter attribute prediction);
    PRED only, LIFT ignores it."""
    vals = np.asarray(values)
    if vals.ndim == 1:
        vals = vals[:, None]
    vals = vals.astype(np.int64)
    n, ncomp = vals.shape
    lift = aps.attr_encoding == AttributeEncoding.LIFT
    if lift or not aps.inter_prediction_enabled:
        ref = None
    ref_pos = ref[0] if ref is not None and len(ref[0]) else None
    m = 0 if ref_pos is None else ref_pos.shape[0]
    levels, nbr, wq, nl = _structure(positions, aps, ref_pos)
    step_at = _step_fn(aps, abh)   # (component, LoD level) -> step
    reg = _region_offsets(positions, abh)

    def stepf(c, lvl_i, idx):
        """Step for component c at level lvl_i for point rows idx —
        scalar without regions, (len(idx),1) with per-point offsets."""
        if reg is None:
            return step_at(c, lvl_i)
        q = step_at.qp(c, lvl_i) + reg[idx, 1 if c > 0 else 0]
        return step_q16_vec(q)[:, None]

    q_out = np.zeros((n, ncomp), dtype=np.int64)  # in Morton order
    # last-component prediction: LIFT only (reference applies it in
    # the lifting colour path, AttributeEncoder.cpp:1420); one Q2
    # coefficient per LoD level in the ABH
    lcp_on = (aps.last_component_prediction_enabled and ncomp == 3
              and lift and abh is not None)
    lift_lcp = np.zeros(nl, dtype=np.int64)
    # inter-component (chroma-from-luma) prediction: PRED only
    icp_on = (aps.inter_component_prediction_enabled and ncomp == 3
              and not lift and abh is not None)

    dbg = os.environ.get("TMC13_DEBUG_LIFT")
    if lift:
        qw8, factor = _lift_quant_weights(levels, nbr, wq)
        if dbg:
            for l in range(nl):
                sel = levels == l
                print(f"LIFTDBG lvl={l} n={int(sel.sum())} "
                      f"w_mean={qw8[sel].mean()/256:.2f} "
                      f"w_max={qw8[sel].max()/256:.0f} "
                      f"fac_mean={factor[sel].mean()/256:.2f}")
        work = vals.astype(np.int64).copy()
        # analysis fine -> coarse: details then update
        for l in range(nl - 1, 0, -1):
            sel = levels == l
            si = np.nonzero(sel)[0]
            pred = lod_ops.predict_q16(work, nbr[sel], wq[sel])
            detail = work[sel] - pred
            # quantise details now (synthesis sees quantised ones)
            q = np.stack([_quant(detail[:, c:c + 1], stepf(c, l, si),
                                 factor[sel])[:, 0]
                          for c in range(ncomp)], axis=1)
            dq = np.stack([_dequant(q[:, c:c + 1], stepf(c, l, si),
                                    factor[sel])[:, 0]
                           for c in range(ncomp)], axis=1)
            if lcp_on:
                k = _lcp_estimate(detail[:, 1], detail[:, 2])
                lift_lcp[l] = k
                pred2 = _lcp_pred(k, dq[:, 1], True)
                q[:, 2] = _quant((detail[:, 2] - pred2)[:, None],
                                 stepf(2, l, si), factor[sel])[:, 0]
                dq[:, 2] = _dequant(q[:, 2:3], stepf(2, l, si),
                                    factor[sel])[:, 0] + pred2
            q_out[sel] = q
            work[sel] = dq  # hold dequantised details
            work += _lift_update(dq, nbr[sel], wq[sel], qw8[si],
                                 work.shape, ncomp)
        # coarsest level: code values themselves.  The quant factor
        # applies here too (reference AttributeEncoder.cpp:1443 scales
        # EVERY lifted coefficient): base-layer points carry the whole
        # pyramid's mass, so their finer effective step is what holds
        # reconstruction quality at coarse QPs.
        sel0 = levels == 0
        si0 = np.nonzero(sel0)[0]
        q0 = np.stack([_quant(work[sel0][:, c:c + 1],
                              stepf(c, 0, si0), factor[sel0])[:, 0]
                       for c in range(ncomp)], axis=1)
        if lcp_on:
            v0 = work[sel0]
            k = _lcp_estimate(v0[:, 1], v0[:, 2])
            lift_lcp[0] = k
            dq1 = _dequant(q0[:, 1:2], stepf(1, 0, si0),
                           factor[sel0])[:, 0]
            pred2 = _lcp_pred(k, dq1, True)
            q0[:, 2] = _quant((v0[:, 2] - pred2)[:, None],
                              stepf(2, 0, si0), factor[sel0])[:, 0]
        q_out[sel0] = q0
        if lcp_on:
            abh.lcp_coeffs.extend(int(v) for v in lift_lcp)
        if dbg:
            for l in range(nl):
                sel = levels == l
                qq = q_out[sel]
                print(f"LIFTDBG lvl={l} absq_mean={np.abs(qq).mean():.2f} "
                      f"absq_sum={int(np.abs(qq).sum())} "
                      f"nz={float((qq != 0).mean()):.3f} "
                      f"est_bits={int(np.abs(qq).clip(1).astype(float).__abs__().sum())}")
    else:
        # predicting transform: per-level chunks so explicit per-point
        # prediction modes (reference decidePredModeRefl,
        # AttributeEncoder.cpp:663) interleave with the residuals
        enc = entropy.RangeEncoder()

        def code_chunk(q):
            for c in range(ncomp):
                cs = ctx.residuals[c * RES_CTX_SIZE:
                                   (c + 1) * RES_CTX_SIZE]
                enc.residuals(cs, q[:, c].astype(np.int32),
                              _RES_PREFIX_MAX, _RES_K)

        # recon lives in augmented space: rows [0, m) are the fixed
        # reference attributes, rows [m, m+n) the current slice
        recon = np.zeros((m + n, ncomp), dtype=np.int64)
        if m:
            recon[:m] = np.asarray(ref[1], dtype=np.int64).reshape(m, -1)
        # coarsest level: sequential chain unless reference points
        # already provide predictors (then it vectorises like the rest)
        idx0 = np.nonzero(levels == 0)[0]
        start_level = 0 if m else 1
        if not m:
            q0 = np.zeros((idx0.size, ncomp), dtype=np.int64)
            for j, i in enumerate(idx0):
                pred = lod_ops.predict_q16(
                    recon, nbr[i:i + 1], wq[i:i + 1])[0]
                res = vals[i] - pred
                ii = np.array([i])
                q = np.array([_quant(res[c:c + 1][None, :],
                                     stepf(c, 0, ii))[0, 0]
                              for c in range(ncomp)])
                dq = np.array([_dequant(q[c:c + 1][None, :],
                                        stepf(c, 0, ii))[0, 0]
                               for c in range(ncomp)])
                q0[j] = q
                recon[m + i] = pred + dq
            code_chunk(q0)
        thr = aps.adaptive_prediction_threshold
        use_modes = aps.max_direct_predictors > 0
        for l in range(start_level, nl):
            sel = np.nonzero(levels == l)[0]
            modes = np.zeros(sel.size, dtype=np.int64)
            if use_modes:
                elig = _mode_eligible(recon, nbr[sel], wq[sel], thr)
                if elig.any():
                    e = sel[elig]
                    # candidate costs from TRUE values (encoder only)
                    cands = [lod_ops.predict_q16(recon, nbr[e], wq[e])]
                    for j in range(nbr.shape[1]):
                        cands.append(recon[np.maximum(nbr[e, j], 0)])
                    costs = np.stack(
                        [np.abs(vals[e] - cd).sum(axis=1)
                         for cd in cands], axis=1)
                    valid = np.concatenate(
                        [np.ones((e.size, 1), bool), nbr[e] >= 0], axis=1)
                    costs = np.where(valid, costs, np.int64(1) << 50)
                    mm = np.argmin(costs, axis=1)
                    modes[elig] = mm
                    ids = np.empty(2 * e.size, dtype=np.int32)
                    bits = np.empty(2 * e.size, dtype=np.uint8)
                    ids[0::2] = 0
                    ids[1::2] = 1
                    bits[0::2] = (mm >> 1) & 1
                    bits[1::2] = mm & 1
                    enc.bits(ctx.pred_modes, ids, bits)
            pred = _predict_with_modes(recon, nbr[sel], wq[sel], modes)
            res = vals[sel] - pred
            q = np.stack([_quant(res[:, c:c + 1],
                                 stepf(c, l, sel))[:, 0]
                          for c in range(ncomp)], axis=1)
            dq = np.stack([_dequant(q[:, c:c + 1],
                                    stepf(c, l, sel))[:, 0]
                           for c in range(ncomp)], axis=1)
            if icp_on:
                dq0 = dq[:, 0]
                for k in (1, 2):
                    ck = _lcp_estimate(dq0, res[:, k])
                    abh.icp_coeffs.append(ck)
                    pr = _icp_pred(ck, dq0)
                    q[:, k] = _quant((res[:, k] - pr)[:, None],
                                     stepf(k, l, sel))[:, 0]
                    dq[:, k] = _dequant(q[:, k:k + 1],
                                        stepf(k, l, sel))[:, 0] + pr
            code_chunk(q)
            recon[m + sel] = pred + dq
        return enc.get_bytes()

    enc = entropy.RangeEncoder()
    if aps.scalable_lifting_enabled:
        # scalable lifting (reference aps_scalable_enable_flag):
        # independent per-level chunks so a decoder can stop after
        # any LoD level and synthesise with zero finer details
        for l in range(nl):
            sel = levels == l
            for c in range(ncomp):
                cslice = ctx.residuals[c * RES_CTX_SIZE:
                                       (c + 1) * RES_CTX_SIZE]
                enc.residuals(cslice,
                              q_out[sel][:, c].astype(np.int32),
                              _RES_PREFIX_MAX, _RES_K)
        return enc.get_bytes()
    # non-scalable: one stream in LoD order (coarse first)
    order = lod_ops.lod_order(levels)
    for c in range(ncomp):
        cslice = ctx.residuals[c * RES_CTX_SIZE:(c + 1) * RES_CTX_SIZE]
        enc.residuals(cslice, q_out[order][:, c].astype(np.int32),
                      _RES_PREFIX_MAX, _RES_K)
    return enc.get_bytes()


def decode(data: bytes, positions: np.ndarray,
           aps: AttributeParameterSet, desc: AttributeDescription,
           ctx: AttributeContexts, ref=None,
           max_levels: int = 0, abh=None) -> np.ndarray:
    """max_levels > 0: progressive decode — only the first max_levels
    LoD chunks are entropy-decoded; finer points reconstruct as pure
    predictions (residual 0), degrading gracefully (the scalable-decode
    analogue of the reference's LoD truncation, PRED path only)."""
    n = positions.shape[0]
    ncomp = desc.num_components
    lift = aps.attr_encoding == AttributeEncoding.LIFT
    if lift or not aps.inter_prediction_enabled:
        ref = None
    ref_pos = ref[0] if ref is not None and len(ref[0]) else None
    m = 0 if ref_pos is None else ref_pos.shape[0]
    levels, nbr, wq, nl = _structure(positions, aps, ref_pos)
    step_at = _step_fn(aps, abh)   # (component, LoD level) -> step
    reg = _region_offsets(positions, abh)

    def stepf(c, lvl_i, idx):
        """Step for component c at level lvl_i for point rows idx —
        scalar without regions, (len(idx),1) with per-point offsets."""
        if reg is None:
            return step_at(c, lvl_i)
        q = step_at.qp(c, lvl_i) + reg[idx, 1 if c > 0 else 0]
        return step_q16_vec(q)[:, None]
    lcp_on = (aps.last_component_prediction_enabled and ncomp == 3
              and lift and abh is not None
              and len(abh.lcp_coeffs) > 0)
    icp_on = (aps.inter_component_prediction_enabled and ncomp == 3
              and not lift and abh is not None
              and len(abh.icp_coeffs) > 0)
    icp_idx = [0]

    def lcp_k(l):
        return abh.lcp_coeffs[min(l, len(abh.lcp_coeffs) - 1)]

    dec = entropy.RangeDecoder(data)

    if not lift:
        def read_chunk(count):
            cols = []
            for c in range(ncomp):
                cs = ctx.residuals[c * RES_CTX_SIZE:
                                   (c + 1) * RES_CTX_SIZE]
                cols.append(dec.residuals(cs, count,
                                          _RES_PREFIX_MAX, _RES_K))
            return np.stack(cols, axis=1).astype(np.int64)

        recon = np.zeros((m + n, ncomp), dtype=np.int64)
        if m:
            recon[:m] = np.asarray(ref[1], dtype=np.int64).reshape(m, -1)
        idx0 = np.nonzero(levels == 0)[0]
        start_level = 0 if m else 1
        if not m:
            q0 = read_chunk(idx0.size)
            for j, i in enumerate(idx0):
                pred = lod_ops.predict_q16(
                    recon, nbr[i:i + 1], wq[i:i + 1])[0]
                ii = np.array([i])
                dq = np.array([_dequant(q0[j, c:c + 1][None, :],
                                        stepf(c, 0, ii))[0, 0]
                               for c in range(ncomp)])
                recon[m + i] = pred + dq
        thr = aps.adaptive_prediction_threshold
        use_modes = aps.max_direct_predictors > 0
        for l in range(start_level, nl):
            sel = np.nonzero(levels == l)[0]
            truncated = max_levels > 0 and l >= max_levels
            modes = np.zeros(sel.size, dtype=np.int64)
            if use_modes and not truncated:
                elig = _mode_eligible(recon, nbr[sel], wq[sel], thr)
                ne = int(elig.sum())
                if ne:
                    ids = np.empty(2 * ne, dtype=np.int32)
                    ids[0::2] = 0
                    ids[1::2] = 1
                    bits = dec.bits(ctx.pred_modes, ids)
                    modes[elig] = (bits[0::2].astype(np.int64) << 1) \
                        | bits[1::2]
            pred = _predict_with_modes(recon, nbr[sel], wq[sel], modes)
            if truncated:
                recon[m + sel] = pred
                continue
            q = read_chunk(sel.size)
            dq = np.stack([_dequant(q[:, c:c + 1],
                                    stepf(c, l, sel))[:, 0]
                           for c in range(ncomp)], axis=1)
            if icp_on:
                dq0 = dq[:, 0]
                for k in (1, 2):
                    i = min(icp_idx[0], len(abh.icp_coeffs) - 1)
                    icp_idx[0] += 1
                    dq[:, k] += _icp_pred(abh.icp_coeffs[i], dq0)
            recon[m + sel] = pred + dq
        out = recon[m:]
        if ncomp == 1:
            return out[:, 0]
        return out

    q = np.zeros((n, ncomp), dtype=np.int64)
    if aps.scalable_lifting_enabled:
        # per-level chunks; max_levels truncates (zero details)
        for l in range(nl):
            if max_levels > 0 and l >= max_levels:
                break
            idx = np.nonzero(levels == l)[0]
            for c in range(ncomp):
                cslice = ctx.residuals[c * RES_CTX_SIZE:
                                       (c + 1) * RES_CTX_SIZE]
                q[idx, c] = dec.residuals(cslice, idx.size,
                                          _RES_PREFIX_MAX, _RES_K)
    else:
        order = lod_ops.lod_order(levels)
        q_lod = np.zeros((n, ncomp), dtype=np.int64)
        for c in range(ncomp):
            cslice = ctx.residuals[c * RES_CTX_SIZE:
                                   (c + 1) * RES_CTX_SIZE]
            q_lod[:, c] = dec.residuals(cslice, n, _RES_PREFIX_MAX,
                                        _RES_K)
        q[order] = q_lod  # back to Morton order

    dbg = os.environ.get("TMC13_DEBUG_LIFT")
    if lift:
        qw8, factor = _lift_quant_weights(levels, nbr, wq)
        if dbg:
            for l in range(nl):
                sel = levels == l
                print(f"LIFTDBG lvl={l} n={int(sel.sum())} "
                      f"w_mean={qw8[sel].mean()/256:.2f} "
                      f"w_max={qw8[sel].max()/256:.0f} "
                      f"fac_mean={factor[sel].mean()/256:.2f}")
        work = np.zeros((n, ncomp), dtype=np.int64)
        sel0 = levels == 0
        si0 = np.nonzero(sel0)[0]
        work[sel0] = np.stack(
            [_dequant(q[sel0][:, c:c + 1], stepf(c, 0, si0),
                      factor[sel0])[:, 0]
             for c in range(ncomp)], axis=1)
        if lcp_on:
            work[sel0, 2] += _lcp_pred(lcp_k(0), work[sel0, 1], True)
        # synthesis coarse -> fine: un-update then un-predict
        for l in range(1, nl):
            sel = levels == l
            si = np.nonzero(sel)[0]
            dq = np.stack([_dequant(q[sel][:, c:c + 1],
                                    stepf(c, l, si),
                                    factor[sel])[:, 0]
                           for c in range(ncomp)], axis=1)
            if lcp_on:
                dq[:, 2] += _lcp_pred(lcp_k(l), dq[:, 1], True)
            work -= _lift_update(dq, nbr[sel], wq[sel], qw8[si],
                                 work.shape, ncomp)
            pred = lod_ops.predict_q16(work, nbr[sel], wq[sel])
            work[sel] = pred + dq
        out = work
    else:
        recon = np.zeros((n, ncomp), dtype=np.int64)
        idx0 = np.nonzero(levels == 0)[0]
        for i in idx0:
            pred = lod_ops.predict_q16(recon, nbr[i:i + 1], wq[i:i + 1])[0]
            dq = np.array([_dequant(q[i, c:c + 1][None, :],
                                    stepf(c, 0, np.array([i])))[0, 0]
                           for c in range(ncomp)])
            recon[i] = pred + dq
        for l in range(1, nl):
            sel = levels == l
            pred = lod_ops.predict_q16(recon, nbr[sel], wq[sel])
            dq = np.stack([_dequant(q[sel][:, c:c + 1],
                                    stepf(c, l, np.nonzero(sel)[0]))[:, 0]
                           for c in range(ncomp)], axis=1)
            recon[sel] = pred + dq
        out = recon
    if ncomp == 1:
        return out[:, 0]
    return out
