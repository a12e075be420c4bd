"""Recolouring: attribute transfer source cloud -> reconstructed geometry.

Faithful vectorised port of the reference `recolourColour` /
`recolourReflectance` (pointset_processing.cpp:253-925):

* forward set Ψ₁: the numNeighboursFwd nearest SOURCE points per
  target, searched at the target position mapped into the source
  domain (float, unrounded - pointset_processing.cpp:302).  The tail
  is dropped while the farthest squared distance exceeds
  maxGeometryDist2Fwd; an exact positional match (d² < 1e-4)
  short-circuits to that single source when
  skipAvgIfIdenticalSourcePointPresentFwd; otherwise neighbours are
  blended with weights 1/(d² + distOffsetFwd).
* backward set Ψ₂: each source contributes its colour to its
  numNeighboursBwd nearest targets (source position mapped into the
  target domain), weighted 1/(√d² + distOffsetBwd).
* final value (m42538 fixWeight): start from the backward centroid and
  exhaustively refine within ±searchRange per component, minimising
  max(‖c−Ψ̄₁‖²/Ntarget, Σ_{q∈Ψ₂}‖c−q‖²/Nsource)
  (pointset_processing.cpp:530-590).  Targets with an empty backward
  set keep the forward value.

Cap parameters ≥ 512 are treated as +inf exactly like the reference
(pointset_processing.cpp:280-291) — with the defaults (1000) every cap
is INACTIVE.  The pairwise attribute-distance cascade that the active
caps trigger is approximated per-neighbour against the nearest
neighbour's attribute (non-default configurations only; the CTC never
enables them).

The reference uses nanoflann KD-trees; here candidates come from a
Morton window around the query's insertion position with distances
computed in the true float domain — exact within the window.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mpeg_pcc_tmc13_tpu.models.pointcloud import PointCloud

from ..utils import morton


def knn(src_pos: np.ndarray, query_pos: np.ndarray, k: int = 1,
        window: int = 8):
    """k (approximately) nearest src indices + squared distances per
    integer query point (used by predlift/LoD helpers).  Candidates =
    +-window around the Morton insertion position."""
    nq = query_pos.shape[0]
    ns = src_pos.shape[0]
    if ns == 0 or nq == 0:
        return (np.zeros((nq, k), dtype=np.int64),
                np.zeros((nq, k), dtype=np.int64))
    s_codes = morton.encode(src_pos.astype(np.int64))
    order = np.argsort(s_codes, kind="stable")
    s_sorted = s_codes[order]
    pos_sorted = src_pos[order].astype(np.int64)

    q_codes = morton.encode(query_pos.astype(np.int64))
    ins = np.searchsorted(s_sorted, q_codes)
    offs = np.arange(-window, window, dtype=np.int64)
    cand = np.clip(ins[:, None] + offs[None, :], 0, ns - 1)
    d = pos_sorted[cand] - query_pos[:, None, :].astype(np.int64)
    d2 = np.sum(d * d, axis=-1)
    top = np.argsort(d2, kind="stable", axis=1)[:, :k]
    idx = order[np.take_along_axis(cand, top, axis=1)]
    return idx, np.take_along_axis(d2, top, axis=1)


def nearest_neighbor(src_pos: np.ndarray, query_pos: np.ndarray,
                     window: int = 8) -> np.ndarray:
    """Index of (approximately) nearest src point per query point."""
    idx, _ = knn(src_pos, query_pos, k=1, window=window)
    return idx[:, 0]


@dataclass
class RecolourParams:
    """The reference's 13 recolour* options (TMC3.cpp:1501-1549,
    defaults from there; algorithm pointset_processing.cpp:230+)."""
    num_neighbours_fwd: int = 8
    num_neighbours_bwd: int = 1
    use_dist_weighted_avg_fwd: bool = True
    use_dist_weighted_avg_bwd: bool = True
    skip_avg_if_identical_fwd: bool = True
    skip_avg_if_identical_bwd: bool = False
    dist_offset_fwd: float = 4.0
    dist_offset_bwd: float = 4.0
    max_geometry_dist2_fwd: float = 1000.0
    max_geometry_dist2_bwd: float = 1000.0
    max_attribute_dist2_fwd: float = 1000.0
    max_attribute_dist2_bwd: float = 1000.0
    search_range: int = 1


def _cap(v: float) -> float:
    """Caps >= 512 mean 'no cap' (pointset_processing.cpp:280-291)."""
    return float(v) if v < 512 else np.inf


# native/recolour.cc transfer core (bit-equal to the numpy stages);
# tests flip this off to exercise the numpy spec on the same KNN sets
_NATIVE_TRANSFER = True


def _knn_float(sorted_int_pos: np.ndarray, sorted_codes: np.ndarray,
               order: np.ndarray, qf: np.ndarray, k: int, window: int,
               chunk: int = 1 << 16):
    """k nearest (by float distance) points of an integer-position
    cloud per float query.  Returns (idx into the original order,
    float d2), both sorted ascending by distance.  Native fast path
    (lod.cc knn_float); the numpy fallback differs only in edge-of-
    cloud candidate duplication (encoder-only, non-normative)."""
    nq = qf.shape[0]
    ns = sorted_int_pos.shape[0]
    from mpeg_pcc_tmc13_tpu.bitstream import entropy as _ent
    if _ent._LIB is not None and nq and ns:
        import ctypes as _ct
        if not hasattr(_ent._LIB.knn_float, "_configured"):
            _ent._LIB.knn_float.argtypes = [
                _ct.POINTER(_ct.c_int64), _ct.POINTER(_ct.c_int64),
                _ct.POINTER(_ct.c_double), _ct.POINTER(_ct.c_int64),
                _ct.c_int64, _ct.c_int64, _ct.c_int, _ct.c_int,
                _ct.POINTER(_ct.c_int64), _ct.POINTER(_ct.c_double)]
            _ent._LIB.knn_float._configured = True
        sp = np.ascontiguousarray(sorted_int_pos, dtype=np.int64)
        sc = np.ascontiguousarray(sorted_codes, dtype=np.int64)
        qfc = np.ascontiguousarray(qf, dtype=np.float64)
        qi = np.maximum(np.round(qf), 0).astype(np.int64)
        qc = np.ascontiguousarray(morton.encode(qi), dtype=np.int64)
        oi = np.empty((nq, k), dtype=np.int64)
        od = np.empty((nq, k), dtype=np.float64)
        p = lambda a, t: a.ctypes.data_as(_ct.POINTER(t))
        _ent._LIB.knn_float(
            p(sp, _ct.c_int64), p(sc, _ct.c_int64),
            p(qfc, _ct.c_double), p(qc, _ct.c_int64),
            ns, nq, k, window, p(oi, _ct.c_int64),
            p(od, _ct.c_double))
        return order[oi], od
    idx_out = np.empty((nq, k), dtype=np.int64)
    d2_out = np.empty((nq, k), dtype=np.float64)
    offs = np.arange(-window, window, dtype=np.int64)
    for lo in range(0, nq, chunk):
        q = qf[lo:lo + chunk]
        qi = np.maximum(np.round(q), 0).astype(np.int64)
        ins = np.searchsorted(sorted_codes, morton.encode(qi))
        cand = np.clip(ins[:, None] + offs[None, :], 0, ns - 1)
        d = sorted_int_pos[cand].astype(np.float64) - q[:, None, :]
        d2 = np.einsum("ijk,ijk->ij", d, d)
        top = np.argsort(d2, kind="stable", axis=1)[:, :k]
        idx_out[lo:lo + chunk] = order[np.take_along_axis(cand, top,
                                                          axis=1)]
        d2_out[lo:lo + chunk] = np.take_along_axis(d2, top, axis=1)
    return idx_out, d2_out


def recolour(source: PointCloud, target_positions: np.ndarray,
             source_scale_num: int = 1, source_scale_den: int = 1,
             window: int = 24,
             params: RecolourParams = None) -> PointCloud:
    """Transfer source attributes onto target (reconstructed)
    positions.  target_positions are in the coding grid; the
    source-to-target scale is source_scale_num/source_scale_den."""
    p = params or RecolourParams()
    nt = target_positions.shape[0]
    ns = source.positions.shape[0]
    if nt == 0 or ns == 0:
        return PointCloud(positions=target_positions,
                          colors=None, reflectances=None)

    src_int = np.round(np.asarray(source.positions)).astype(np.int64)
    s_codes = morton.encode(src_int)
    s_order = np.argsort(s_codes, kind="stable")
    s_sorted_codes = s_codes[s_order]
    s_sorted_pos = src_int[s_order]

    tgt_int = target_positions.astype(np.int64)
    t_codes = morton.encode(tgt_int)
    t_order = np.argsort(t_codes, kind="stable")
    t_sorted_codes = t_codes[t_order]
    t_sorted_pos = tgt_int[t_order]

    # target position in the source domain (float, unrounded:
    # pointset_processing.cpp:302)
    t2s = source_scale_den / source_scale_num
    q_src = tgt_int.astype(np.float64) * t2s
    kf = max(int(p.num_neighbours_fwd), 1)
    fwd_idx, fwd_d2 = _knn_float(s_sorted_pos, s_sorted_codes, s_order,
                                 q_src, kf, max(window, 2 * kf))

    cap_gf = _cap(p.max_geometry_dist2_fwd)
    cap_af = _cap(p.max_attribute_dist2_fwd)
    cap_gb = _cap(p.max_geometry_dist2_bwd)
    cap_ab = _cap(p.max_attribute_dist2_bwd)

    # tail-drop on the geometry cap: sorted distances, so popping the
    # tail == keeping the prefix within the cap (always >= 1 kept)
    keep_f = fwd_d2 <= cap_gf
    keep_f[:, 0] = True
    if p.use_dist_weighted_avg_fwd:
        base_w = 1.0 / (fwd_d2 + p.dist_offset_fwd)
    else:
        base_w = np.ones_like(fwd_d2)
    exact = fwd_d2[:, 0] < 0.0001

    # backward: each source contributes to its nearest targets
    kb = max(int(p.num_neighbours_bwd), 1)
    q_tgt = np.asarray(source.positions, dtype=np.float64) / t2s
    bwd_idx, bwd_d2 = _knn_float(t_sorted_pos, t_sorted_codes, t_order,
                                 q_tgt, kb, max(window, 2 * kb))
    bwd_ok = bwd_d2 <= cap_gb
    if p.use_dist_weighted_avg_bwd:
        bwd_w = 1.0 / (np.sqrt(bwd_d2) + p.dist_offset_bwd)
    else:
        bwd_w = np.ones_like(bwd_d2)
    bwd_w = np.where(bwd_ok, bwd_w, 0.0)

    r_src = 1.0 / ns
    r_tgt = 1.0 / nt
    sr = int(p.search_range)

    def _transfer_native(a, bitdepth_max):
        """native/recolour.cc mirror of the numpy stages below —
        identical IEEE-double ops in the same order (incl. numpy's
        pairwise summation for the forward weight row), so outputs are
        bit-equal.  Covers the CTC surface (inactive attribute caps)."""
        from mpeg_pcc_tmc13_tpu.bitstream import entropy as _ent
        if _ent._LIB is None or not _NATIVE_TRANSFER \
                or np.isfinite(cap_af) \
                or np.isfinite(cap_ab) or a.ndim > 2 \
                or (a.ndim == 2 and a.shape[1] > 3):
            return None
        import ctypes as _ct
        lib = _ent._LIB
        if not hasattr(lib.recolour_core, "_configured"):
            lib.recolour_core.argtypes = [
                _ct.POINTER(_ct.c_int64), _ct.c_int64, _ct.c_int32,
                _ct.POINTER(_ct.c_int64), _ct.POINTER(_ct.c_double),
                _ct.c_int64, _ct.c_int32,
                _ct.POINTER(_ct.c_int64), _ct.POINTER(_ct.c_double),
                _ct.c_int32, _ct.c_double, _ct.c_double, _ct.c_double,
                _ct.c_double, _ct.c_int32, _ct.c_int32, _ct.c_double,
                _ct.POINTER(_ct.c_int64)]
            lib.recolour_core.restype = _ct.c_int
            lib.recolour_core._configured = True
        flat = np.ascontiguousarray(
            a.reshape(a.shape[0], -1), dtype=np.int64)
        c = flat.shape[1]
        fi = np.ascontiguousarray(fwd_idx, dtype=np.int64)
        fd = np.ascontiguousarray(fwd_d2, dtype=np.float64)
        bi = np.ascontiguousarray(bwd_idx, dtype=np.int64)
        bd = np.ascontiguousarray(bwd_d2, dtype=np.float64)
        out = np.empty((nt, c), dtype=np.int64)
        flags = ((1 if p.use_dist_weighted_avg_fwd else 0)
                 | (2 if p.use_dist_weighted_avg_bwd else 0)
                 | (4 if p.skip_avg_if_identical_fwd else 0))
        pp = lambda arr, t: arr.ctypes.data_as(_ct.POINTER(t))
        rc = lib.recolour_core(
            pp(flat, _ct.c_int64), ns, c,
            pp(fi, _ct.c_int64), pp(fd, _ct.c_double), nt, fwd_idx.shape[1],
            pp(bi, _ct.c_int64), pp(bd, _ct.c_double), bwd_idx.shape[1],
            cap_gf if np.isfinite(cap_gf) else 1e300,
            cap_gb if np.isfinite(cap_gb) else 1e300,
            float(p.dist_offset_fwd), float(p.dist_offset_bwd),
            flags, sr, bitdepth_max, pp(out, _ct.c_int64))
        if rc != 0:
            return None
        return out.astype(a.dtype).reshape((nt,) + a.shape[1:])

    def transfer(attr):
        if attr is None:
            return None
        a = np.asarray(attr)
        # reference clipMax = (1<<bitdepth)-1 (attrDesc); derived here
        # from the storage dtype
        if np.issubdtype(a.dtype, np.unsignedinteger):
            bitdepth_max = float((1 << (8 * a.dtype.itemsize)) - 1)
        else:
            bitdepth_max = 65535.0
        nat = _transfer_native(a, bitdepth_max)
        if nat is not None:
            return nat
        flat = a.reshape(a.shape[0], -1).astype(np.float64)
        c = flat.shape[1]

        # ---- forward value (refinedColors1) ----
        sv = flat[fwd_idx]                               # (T, k, C)
        w = base_w * keep_f
        if np.isfinite(cap_af):
            # approximation of the pairwise cascade (non-default only)
            ad2 = ((sv - sv[:, :1]) ** 2).sum(axis=-1)
            w = w * (ad2 <= cap_af)
            w[:, 0] = np.where(keep_f[:, 0], base_w[:, 0], 0.0)
        wsum = np.maximum(w.sum(axis=1, keepdims=True), 1e-300)
        color1 = np.floor((sv * (w / wsum)[:, :, None]).sum(axis=1)
                          + 0.5)
        np.clip(color1, 0.0, bitdepth_max, out=color1)
        if p.skip_avg_if_identical_fwd and exact.any():
            color1[exact] = flat[fwd_idx[exact, 0]]

        # ---- backward accumulators (Ψ₂): weighted centroid plus the
        # plain sum/sq-sum needed by the candidate error term ----
        sval = flat                                      # (S, C)
        H = np.zeros(nt, dtype=np.float64)
        wS = np.zeros((nt, c), dtype=np.float64)
        wsumb = np.zeros(nt, dtype=np.float64)
        S = np.zeros((nt, c), dtype=np.float64)
        Q = np.zeros(nt, dtype=np.float64)
        for j in range(kb):
            tj = bwd_idx[:, j]
            wj = bwd_w[:, j]
            okj = bwd_ok[:, j]
            np.add.at(H, tj, okj.astype(np.float64))
            np.add.at(wsumb, tj, wj)
            np.add.at(wS, tj, sval * wj[:, None])
            contrib = np.where(okj[:, None], sval, 0.0)
            np.add.at(S, tj, contrib)
            np.add.at(Q, tj, np.where(okj, (sval * sval).sum(axis=1),
                                      0.0))
        has_b = H > 0
        if np.isfinite(cap_ab):
            pass  # active bwd attribute cap: not reached by the CTC

        out = color1.copy()
        if has_b.any():
            centroid2 = wS[has_b] / np.maximum(
                wsumb[has_b], 1e-300)[:, None]
            color0 = np.clip(np.floor(centroid2 + 0.5), 0.0,
                             bitdepth_max)
            c1 = color1[has_b]
            Hb, Sb, Qb = H[has_b], S[has_b], Q[has_b]
            best = color0.copy()
            best_err = np.full(color0.shape[0], np.inf)
            for s1 in range(-sr, sr + 1):
                for s2 in range(-sr, sr + 1):
                    for s3 in range(-sr, sr + 1):
                        if c == 1:
                            if s2 or s3:
                                continue
                            cand = np.clip(color0 + s1, 0.0,
                                           bitdepth_max)
                        else:
                            cand = np.clip(
                                color0 + np.array([s1, s2, s3],
                                                  dtype=np.float64),
                                0.0, bitdepth_max)
                        e1 = ((cand - c1) ** 2).sum(axis=1) * r_tgt
                        e2 = (Hb * (cand * cand).sum(axis=1)
                              - 2.0 * (cand * Sb).sum(axis=1)
                              + Qb) * r_src
                        err = np.maximum(e1, e2)
                        better = err < best_err
                        if better.any():
                            best[better] = cand[better]
                            best_err[better] = err[better]
            out[has_b] = best
        return out.astype(np.int64).reshape(
            (nt,) + a.shape[1:]).astype(a.dtype)

    return PointCloud(
        positions=target_positions,
        colors=transfer(source.colors),
        reflectances=transfer(source.reflectances),
    )
