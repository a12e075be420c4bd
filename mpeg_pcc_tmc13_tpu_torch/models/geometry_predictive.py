"""Predictive geometry codec (LiDAR path): chain prediction.

Counterpart of the reference predictive-tree coder
(`encodePredictiveGeometry` via PredGeomEncoder::encode,
geometry_predictive_encoder.cpp:1151,785; decoder :736; prediction
modes geometry_predictive.h:54-60: None/Delta/Linear2/Linear3).

TPU-first redesign: instead of an explicit tree built with a KD-tree
(reference generateGeomPredictionTree :1186), points are coded as a
single prediction **chain** in a configurable traversal order (the
reference's input sort modes, PredGeomEncOpts::SortMode
geometry_params.h:371-378 — LiDAR sweeps are near-sorted by azimuth
already, which is what makes chain prediction effective).  Because the
chain is lossless, every prediction reads *original* positions, so the
encoder is fully vectorised: all four predictor candidates, per-point
RD mode selection, and residuals are computed in one pass; only the
decoder's recurrence is serial (native predchain_recon).

Syntax per point: 2 mode bits (own adaptive context each, conditioned
on the previous point's mode) + 3 signed residual streams.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from ..bitstream import entropy

from ..utils import morton

# per axis: [0..1] zero flag (chained), [2..26) bit-length prefix
# (entropy resbl op — adaptive magnitude class, bypass mantissa)
_AXIS_CTX = 2 + 24
# mode bits: 2 bits x 4 previous-mode contexts
MODE_CTX_SIZE = 4 * 2
# angular mode adds 2 secondary cartesian residual streams (x, y) —
# 3 (x, y, z) with calibrated laser tables; inter adds a chained
# per-point inter flag (2 contexts)
_INTER_FLAG_OFF = MODE_CTX_SIZE + 6 * _AXIS_CTX
PRED_CTX_SIZE = _INTER_FLAG_OFF + 2
_NN_WINDOW = 8


class SortMode(enum.IntEnum):
    """reference PredGeomEncOpts::SortMode (geometry_params.h:371)."""
    NONE = 0
    MORTON = 1
    AZIMUTH = 2
    RADIUS = 3


@dataclass
class PredGeomContexts:
    """reference PredGeomContexts (geometry_predictive.h:84-137)."""
    ctx: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(PRED_CTX_SIZE))

    def copy(self):
        return PredGeomContexts(self.ctx.copy())


def contexts_from_reference(ctx) -> PredGeomContexts:
    """Carry a reference ``PredGeomContexts`` across as a numpy copy (the
    coder's trained state, which continues across slices and frames)."""
    return PredGeomContexts(np.array(ctx.ctx, copy=True))


def sort_points(positions: np.ndarray, mode: SortMode) -> np.ndarray:
    """Traversal order (permutation into the chain order).

    Azimuth/radius keys are taken around the cloud's xy centroid (the
    sensor origin for a LiDAR sweep is rarely the coordinate origin
    after slice-local translation).  Encoder-side only: the decoder
    simply follows the coded chain order.
    """
    p = positions.astype(np.int64)
    if mode == SortMode.MORTON:
        return np.argsort(morton.encode(p), kind="stable")
    if mode in (SortMode.AZIMUTH, SortMode.RADIUS):
        cx = p[:, 0].mean()
        cy = p[:, 1].mean()
        dx = p[:, 0].astype(np.float64) - cx
        dy = p[:, 1].astype(np.float64) - cy
        key = (np.arctan2(dy, dx) if mode == SortMode.AZIMUTH
               else dx * dx + dy * dy)
        return np.argsort(key, kind="stable")
    return np.arange(p.shape[0])


def _predictions(p: np.ndarray):
    """All candidate predictions per point: (N,4,3)."""
    n = p.shape[0]
    pred = np.zeros((n, 4, 3), dtype=np.int64)
    if n > 1:
        pred[1:, 1] = p[:-1]                                # delta
    if n > 2:
        pred[2:, 2] = 2 * p[1:-1] - p[:-2]                  # linear2
    if n > 3:
        pred[3:, 3] = p[2:-1] + p[1:-2] - p[:-3]            # linear3
    return pred


def _sorted_ref(ref_positions: np.ndarray):
    """Canonical Morton-sorted reference arrays shared by both sides."""
    p = np.clip(ref_positions.astype(np.int64), 0, (1 << 21) - 1)
    codes = morton.encode(p)
    order = np.argsort(codes, kind="stable")
    return codes[order], p[order]


def encode(positions: np.ndarray, enc, ctx: PredGeomContexts,
           sort_mode: SortMode = SortMode.MORTON,
           angular: bool = False, ref_positions: np.ndarray = None,
           lasers=None, origin=None):
    """Encode positions losslessly; returns chain-order permutation.

    angular=True codes in the spherical domain (r, phi, z) with a
    secondary cartesian residual (reference angular predictive
    geometry, generateGeomPredictionTreeAngular
    geometry_predictive_encoder.cpp:1287; GPS angular_enabled).

    origin: slice-local lidar head position (GPS geomAngularOrigin −
    slice origin, reference gbh.geomAngularOrigin): the spherical
    conversion is taken about this point, all THREE components —
    without the z component the laser elevation model is useless and
    the z residual carries the whole head height.  When None, falls
    back to the signalled x/y-mean centring (z uncentred).

    ref_positions: compensated reference-frame points (cartesian mode
    only): points may flag inter prediction from the reference's
    nearest neighbour of the extrapolated position (reference predgeom
    inter flag + ref node, geometry_predictive.h:84-137).
    """
    if angular:
        from ..ops import coords
        order = sort_points(positions, SortMode.AZIMUTH if
                            sort_mode == SortMode.MORTON else sort_mode)
        pc = positions.astype(np.int64)[order]
        if origin is not None:
            centre3 = np.asarray(origin, dtype=np.int64)
        else:
            # signalled sweep centre: LiDAR azimuth/radius live around
            # the sensor origin, not the slice corner
            cx = int(np.round(pc[:, 0].mean())) if pc.size else 0
            cy = int(np.round(pc[:, 1].mean())) if pc.size else 0
            enc.bypass(np.array([cx, cy], dtype=np.uint32),
                       np.array([21, 21], dtype=np.int32))
            centre3 = np.array([cx, cy, 0], dtype=np.int64)
        centred = pc - centre3
        if lasers is not None:
            # calibrated per-laser form: code (r, phi, laser index),
            # z reconstructs from the GPS laser tables + residual.
            # Scan order = (laser, azimuth): the laser column is
            # then piecewise constant and phi monotone per laser
            # (reference per-laser prediction threads)
            theta_q, zoff, npt = lasers
            rpl = coords.xyz_to_rpl(centred, theta_q, zoff, npt)
            ord2 = np.lexsort((rpl[:, 1], rpl[:, 2]))
            rpl = rpl[ord2]
            centred = centred[ord2]
            order = order[ord2]
            if ref_positions is not None and len(ref_positions):
                ref_rpl = coords.xyz_to_rpl(
                    np.asarray(ref_positions, dtype=np.int64)
                    - centre3, theta_q, zoff, npt)
                _chain_encode_rpl_inter(rpl, ref_rpl, enc, ctx)
            else:
                _chain_encode(rpl, enc, ctx)
            approx = coords.rpl_to_xyz(rpl, theta_q, zoff, npt)
            sec = centred - approx               # (N,3), small z too
            ncomp_sec = 3
        else:
            sph = coords.xyz_to_spherical(centred)
            _chain_encode(sph, enc, ctx)
            # secondary residual: xyz - inverse(sph), z exact by design
            approx = coords.spherical_to_xyz(sph)
            sec = centred - approx               # (N,3), z column == 0
            ncomp_sec = 2
        for c in range(ncomp_sec):
            off = MODE_CTX_SIZE + (3 + c) * _AXIS_CTX
            cslice = ctx.ctx[off:off + _AXIS_CTX]
            enc.resbl(cslice, sec[:, c].astype(np.int32))
        return order
    order = sort_points(positions, sort_mode)
    p = positions.astype(np.int64)[order]
    _chain_encode(p, enc, ctx, ref_positions=ref_positions)
    return order


def _rpl_sorted_ref(ref_rpl: np.ndarray):
    """Reference sorted by (laser, phi step) + packed search keys —
    the structural correspondence index for rotating-LiDAR inter."""
    order = np.lexsort((ref_rpl[:, 0], ref_rpl[:, 1],
                        ref_rpl[:, 2]))   # fully canonical
    r = ref_rpl[order]
    keys = r[:, 2] * (np.int64(1) << 40) + r[:, 1]
    return r, keys


def _rpl_candidates(prev_rpl: np.ndarray, ref_sorted: np.ndarray,
                    ref_keys: np.ndarray):
    """Per-row structural predictor: the reference point on the SAME
    laser as the previous decoded point with the next azimuth step
    (reference predgeom inter ref-node selection, adapted to the
    (r, phi, laser) domain).  Returns (cand (K,3), valid (K,))."""
    big = np.int64(1) << 40
    want = prev_rpl[:, 2] * big + prev_rpl[:, 1] + 1
    j = np.searchsorted(ref_keys, want)
    m = ref_keys.shape[0]
    jc = np.minimum(j, m - 1)
    valid = ref_sorted[jc, 2] == prev_rpl[:, 2]
    # walked past the laser segment: fall back to its last entry
    back = (~valid) & (jc > 0)
    jb = np.maximum(jc - 1, 0)
    use_back = back & (ref_sorted[jb, 2] == prev_rpl[:, 2])
    jc = np.where(use_back, jb, jc)
    valid = valid | use_back
    return ref_sorted[jc], valid


def _chain_encode_rpl_inter(p: np.ndarray, ref_rpl: np.ndarray, enc,
                            ctx: PredGeomContexts):
    """Chain coding in (r, phi step, laser) with structural temporal
    prediction: per point, an inter flag selects the reference point
    that continues the previous point's laser sweep."""
    n = p.shape[0]
    if n == 0:
        return
    pred = _predictions(p)
    idx = np.arange(n)[:, None]
    elig = idx >= np.arange(4)[None, :]
    res_all = p[:, None, :] - pred
    cost = np.sum(np.ceil(np.log2(np.abs(res_all) + 1.0)) + 1.0, axis=2)
    cost = np.where(elig, cost, np.inf)
    modes = np.argmin(cost, axis=1).astype(np.uint8)
    res = np.take_along_axis(
        res_all, modes[:, None, None].astype(np.int64), axis=1)[:, 0, :]

    ref_sorted, ref_keys = _rpl_sorted_ref(ref_rpl)
    inter = np.zeros(n, dtype=np.uint8)
    cand = np.zeros((n, 3), dtype=np.int64)
    valid = np.zeros(n, dtype=bool)
    if n > 1:
        cand[1:], valid[1:] = _rpl_candidates(p[:-1], ref_sorted,
                                              ref_keys)
    res_inter = p - cand
    cost_inter = np.where(
        valid,
        np.sum(np.ceil(np.log2(np.abs(res_inter) + 1.0)) + 1.0, axis=1),
        np.inf)
    best_intra = np.min(cost, axis=1)
    inter = (cost_inter < best_intra).astype(np.uint8)
    sel = inter.astype(bool)
    res[sel] = res_inter[sel]
    prev = np.concatenate([[0], inter[:-1]]).astype(np.int32)
    fslice = ctx.ctx[_INTER_FLAG_OFF:_INTER_FLAG_OFF + 2]
    enc.bits(fslice, prev, inter)
    m_in = modes[~sel]
    ni = m_in.shape[0]
    prev_modes = np.concatenate([[0], m_in[:-1]]).astype(np.int32)
    ids = np.empty(2 * ni, dtype=np.int32)
    bits = np.empty(2 * ni, dtype=np.uint8)
    ids[0::2] = prev_modes * 2
    ids[1::2] = prev_modes * 2 + 1
    bits[0::2] = (m_in >> 1)
    bits[1::2] = (m_in & 1)
    enc.bits(ctx.ctx, ids, bits)
    for c in range(3):
        off = MODE_CTX_SIZE + c * _AXIS_CTX
        cslice = ctx.ctx[off:off + _AXIS_CTX]
        enc.resbl(cslice, res[:, c].astype(np.int32))


def _chain_decode_rpl_inter(n: int, dec, ctx: PredGeomContexts,
                            ref_rpl: np.ndarray) -> np.ndarray:
    """Mirror of _chain_encode_rpl_inter (sequential reconstruction)."""
    fslice = ctx.ctx[_INTER_FLAG_OFF:_INTER_FLAG_OFF + 2]
    inter = dec.bits_chain(fslice, n)
    ni = n - int(inter.sum())
    modes = np.zeros(n, dtype=np.uint8)
    modes[inter == 0] = dec.mode_chain(ctx.ctx, ni)
    res = np.zeros((n, 3), dtype=np.int64)
    for c in range(3):
        off = MODE_CTX_SIZE + c * _AXIS_CTX
        cslice = ctx.ctx[off:off + _AXIS_CTX]
        res[:, c] = dec.resbl(cslice, n)
    ref_sorted, ref_keys = _rpl_sorted_ref(ref_rpl)
    out = np.zeros((n, 3), dtype=np.int64)
    if entropy.native_available():
        import ctypes
        lib = entropy._LIB
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        if not hasattr(lib, "_rpl_set"):
            lib.predchain_recon_rpl_inter.argtypes = [
                i64p, u8p, u8p, i64p, ctypes.c_int64, i64p,
                ctypes.c_int64]
            lib._rpl_set = True
        r = np.ascontiguousarray(res, dtype=np.int64)
        mo = np.ascontiguousarray(modes, dtype=np.uint8)
        fl = np.ascontiguousarray(inter, dtype=np.uint8)
        rs = np.ascontiguousarray(ref_sorted, dtype=np.int64)
        lib.predchain_recon_rpl_inter(
            r.ctypes.data_as(i64p), mo.ctypes.data_as(u8p),
            fl.ctypes.data_as(u8p), out.ctypes.data_as(i64p), n,
            rs.ctypes.data_as(i64p), ref_sorted.shape[0])
        return out
    for i in range(n):
        if inter[i] and i >= 1:
            c, v = _rpl_candidates(out[i - 1:i], ref_sorted, ref_keys)
            base = c[0]
        else:
            m = modes[i]
            if m == 0 or i == 0:
                base = np.zeros(3, dtype=np.int64)
            elif m == 1:
                base = out[i - 1]
            elif m == 2:
                base = 2 * out[i - 1] - out[i - 2]
            else:
                base = out[i - 1] + out[i - 2] - out[i - 3]
        out[i] = base + res[i]
    return out


def _chain_encode(p: np.ndarray, enc, ctx: PredGeomContexts,
                  ref_positions: np.ndarray = None):
    n = p.shape[0]
    if n == 0:
        return
    pred = _predictions(p)
    # mode eligibility: point i can use mode m only if i >= m
    idx = np.arange(n)[:, None]
    elig = idx >= np.arange(4)[None, :]
    res_all = p[:, None, :] - pred                          # (N,4,3)
    # cost: total magnitude bits (encoder heuristic, reference
    # estimateBits geometry_predictive_encoder.cpp:647)
    cost = np.sum(np.ceil(np.log2(np.abs(res_all) + 1.0)) + 1.0, axis=2)
    cost = np.where(elig, cost, np.inf)
    modes = np.argmin(cost, axis=1).astype(np.uint8)
    res = np.take_along_axis(
        res_all, modes[:, None, None].astype(np.int64), axis=1)[:, 0, :]

    use_inter = ref_positions is not None and len(ref_positions) > 0
    inter = np.zeros(n, dtype=np.uint8)
    if use_inter:
        from ..ops import recolour as recolour_ops
        ref_codes, ref_xyz = _sorted_ref(ref_positions)
        # extrapolated query position per point (lossless chain: the
        # true previous points equal the decoded ones)
        e = np.zeros((n, 3), dtype=np.int64)
        e[2:] = np.clip(2 * p[1:-1] - p[:-2], 0, (1 << 21) - 1)
        nn_idx, _ = recolour_ops.knn(ref_xyz, e, k=1,
                                     window=_NN_WINDOW)
        cand = ref_xyz[nn_idx[:, 0]]
        res_inter = p - cand
        cost_inter = np.sum(
            np.ceil(np.log2(np.abs(res_inter) + 1.0)) + 1.0, axis=1)
        best_intra = np.min(cost, axis=1)
        inter[2:] = (cost_inter < best_intra)[2:].astype(np.uint8)
        sel = inter.astype(bool)
        res[sel] = res_inter[sel]
        # chained inter flags for every point
        prev = np.concatenate([[0], inter[:-1]]).astype(np.int32)
        fslice = ctx.ctx[_INTER_FLAG_OFF:_INTER_FLAG_OFF + 2]
        enc.bits(fslice, prev, inter)
        intra_rows = ~sel
    else:
        intra_rows = np.ones(n, dtype=bool)

    # mode bits for intra points only: ctx = prev_mode * 2 + bit_index,
    # hi/lo interleaved per point (matches the decoder's order)
    m_in = modes[intra_rows]
    ni = m_in.shape[0]
    prev_modes = np.concatenate([[0], m_in[:-1]]).astype(np.int32)
    ids = np.empty(2 * ni, dtype=np.int32)
    bits = np.empty(2 * ni, dtype=np.uint8)
    ids[0::2] = prev_modes * 2
    ids[1::2] = prev_modes * 2 + 1
    bits[0::2] = (m_in >> 1)
    bits[1::2] = (m_in & 1)
    enc.bits(ctx.ctx, ids, bits)
    # residual streams per axis
    for c in range(3):
        off = MODE_CTX_SIZE + c * _AXIS_CTX
        cslice = ctx.ctx[off:off + _AXIS_CTX]
        enc.resbl(cslice, res[:, c].astype(np.int32))


def decode(num_points: int, dec, ctx: PredGeomContexts,
           angular: bool = False,
           ref_positions: np.ndarray = None,
           lasers=None, origin=None) -> np.ndarray:
    n = num_points
    if n == 0:
        return np.zeros((0, 3), dtype=np.int64)
    if angular:
        from ..ops import coords
        if origin is not None:
            centre3 = np.asarray(origin, dtype=np.int64)
        else:
            centre = dec.bypass(np.array([21, 21], dtype=np.int32))
            centre3 = np.array([int(centre[0]), int(centre[1]), 0],
                               dtype=np.int64)
        if (lasers is not None and ref_positions is not None
                and len(ref_positions)):
            theta_q, zoff, npt = lasers
            ref_rpl = coords.xyz_to_rpl(
                np.asarray(ref_positions, dtype=np.int64) - centre3,
                theta_q, zoff, npt)
            sph = _chain_decode_rpl_inter(n, dec, ctx, ref_rpl)
        else:
            sph = _chain_decode(n, dec, ctx)
        sec = np.zeros((n, 3), dtype=np.int64)
        ncomp_sec = 3 if lasers is not None else 2
        for c in range(ncomp_sec):
            off = MODE_CTX_SIZE + (3 + c) * _AXIS_CTX
            cslice = ctx.ctx[off:off + _AXIS_CTX]
            sec[:, c] = dec.resbl(cslice, n)
        if lasers is not None:
            theta_q, zoff, npt = lasers
            out = coords.rpl_to_xyz(sph, theta_q, zoff, npt) + sec
        else:
            out = coords.spherical_to_xyz(sph) + sec
        out += centre3
        return out
    return _chain_decode(n, dec, ctx, ref_positions=ref_positions)


def _chain_decode(n: int, dec, ctx: PredGeomContexts,
                  ref_positions: np.ndarray = None) -> np.ndarray:
    use_inter = ref_positions is not None and len(ref_positions) > 0
    inter = np.zeros(n, dtype=np.uint8)
    if use_inter:
        fslice = ctx.ctx[_INTER_FLAG_OFF:_INTER_FLAG_OFF + 2]
        inter = dec.bits_chain(fslice, n)
    ni = n - int(inter.sum())
    # mode bits chain on the previous decoded mode (intra points only)
    modes = np.zeros(n, dtype=np.uint8)
    m_in = dec.mode_chain(ctx.ctx, ni)
    modes[inter == 0] = m_in
    res = np.zeros((n, 3), dtype=np.int64)
    for c in range(3):
        off = MODE_CTX_SIZE + c * _AXIS_CTX
        cslice = ctx.ctx[off:off + _AXIS_CTX]
        res[:, c] = dec.resbl(cslice, n)

    out = np.zeros((n, 3), dtype=np.int64)
    if use_inter:
        ref_codes, ref_xyz = _sorted_ref(ref_positions)
    if entropy.native_available():
        import ctypes
        lib = entropy._LIB
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        if not hasattr(lib, "_predchain_set"):
            lib.predchain_recon.argtypes = [i64p, u8p, i64p,
                                            ctypes.c_int64]
            lib.predchain_recon_inter.argtypes = [
                i64p, u8p, u8p, i64p, ctypes.c_int64, i64p, i64p,
                ctypes.c_int64, ctypes.c_int32]
            lib._predchain_set = True
        r = np.ascontiguousarray(res, dtype=np.int64)
        m = np.ascontiguousarray(modes, dtype=np.uint8)
        if use_inter:
            rc = np.ascontiguousarray(ref_codes, dtype=np.int64)
            rx = np.ascontiguousarray(ref_xyz, dtype=np.int64)
            fl = np.ascontiguousarray(inter, dtype=np.uint8)
            lib.predchain_recon_inter(
                r.ctypes.data_as(i64p), m.ctypes.data_as(u8p),
                fl.ctypes.data_as(u8p), out.ctypes.data_as(i64p), n,
                rc.ctypes.data_as(i64p), rx.ctypes.data_as(i64p),
                len(rc), _NN_WINDOW)
        else:
            lib.predchain_recon(
                r.ctypes.data_as(i64p), m.ctypes.data_as(u8p),
                out.ctypes.data_as(i64p), n)
    else:
        from ..ops import recolour as recolour_ops
        for i in range(n):
            if use_inter and inter[i] and i >= 2:
                e = np.clip(2 * out[i - 1] - out[i - 2], 0,
                            (1 << 21) - 1)[None, :]
                idx, _ = recolour_ops.knn(ref_xyz, e, k=1,
                                          window=_NN_WINDOW)
                p = ref_xyz[idx[0, 0]]
            else:
                m = modes[i]
                if m == 0:
                    p = np.zeros(3, dtype=np.int64)
                elif m == 1:
                    p = out[i - 1]
                elif m == 2:
                    p = 2 * out[i - 1] - out[i - 2]
                else:
                    p = out[i - 1] + out[i - 2] - out[i - 3]
            out[i] = p + res[i]
    return out
