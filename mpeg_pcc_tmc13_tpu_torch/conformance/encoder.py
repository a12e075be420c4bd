"""Encode point clouds into reference (tmc3) bitstreams.

The mirror of conformance/decoder.py: produces TLV streams in the
reference syntax that the tmc3 binary decodes bit-exactly.  Because it
replays the identical context machinery (native/refcodec.cc), the AEC
payload is byte-identical to what tmc3 itself produces for the same
tool configuration — RD parity with the reference on this tool set is
by construction, not by tuning.

Scope: octree geometry, intra, planar/IDCM/angular/scaling off, single
entropy stream, bitwise occupancy, cubic tree (QTBT schedules accepted
when supplied), unique or duplicated points.

The PyTorch + CUDA port's copy of
``mpeg_pcc_tmc13_tpu/conformance/encoder.py``, imports only changed.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import ref_hls
from .decoder import _load, geom_params_array


def _encode_brick_native(positions: np.ndarray, axes: np.ndarray,
                         gps: ref_hls.RefGps,
                         bypass_no_update: bool = False,
                         stream_cnt_minus1: int = 0,
                         cabac_bypass: bool = False) -> bytes:
    lib = _load()
    c = ctypes
    if not hasattr(lib.tmc13ref_encode_octree_intra, "_configured"):
        lib.tmc13ref_encode_octree_intra.argtypes = [
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32),
            c.POINTER(c.c_uint8), c.c_int,
        ]
        lib.tmc13ref_encode_octree_intra.restype = c.c_int
        lib.tmc13ref_encode_octree_intra_ms.argtypes = [
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32),
            c.POINTER(c.c_uint8), c.c_int, c.c_int,
        ]
        lib.tmc13ref_encode_octree_intra_ms.restype = c.c_int
        lib.tmc13ref_encode_octree_intra._configured = True
    pos32 = np.ascontiguousarray(positions, dtype=np.int32)
    gp = geom_params_array(gps, bypass_no_update,
                           cabac_bypass=cabac_bypass)
    cap = max(int(pos32.shape[0] * 16 + (1 << 16)), 1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    if stream_cnt_minus1:
        n = lib.tmc13ref_encode_octree_intra_ms(
            pos32.ctypes.data_as(c.POINTER(c.c_int32)), pos32.shape[0],
            axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
            gp.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_uint8)), cap,
            stream_cnt_minus1)
    else:
        n = lib.tmc13ref_encode_octree_intra(
            pos32.ctypes.data_as(c.POINTER(c.c_int32)), pos32.shape[0],
            axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
            gp.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"refcodec encode failed rc={n}")
    return out[:n].tobytes()


def _encode_brick_native_inter(positions: np.ndarray,
                               axes: np.ndarray,
                               gps: ref_hls.RefGps,
                               gbh: "ref_hls.RefGbh",
                               ref_global: np.ndarray,
                               origin: np.ndarray,
                               motion_window_size: int,
                               min_pos: np.ndarray,
                               bypass_no_update: bool = False,
                               cabac_bypass: bool = False,
                               ang_origin=None) -> bytes:
    """Encode one inter octree brick (encodeGeometryOctree inter path,
    geometry_octree_encoder.cpp:1875-1894).  ``ref_global`` is the
    previous frame's reconstruction in slice-global STV; with cuboid
    GM the per-LPU flags are coded natively ahead of the octree.
    ``ang_origin`` (slice-local lidar head) selects the angular
    tool-set entry."""
    lib = _load()
    c = ctypes
    pos32 = np.ascontiguousarray(positions, dtype=np.int32)
    gp = geom_params_array(gps, bypass_no_update,
                           cabac_bypass=cabac_bypass)
    cap = max(int(pos32.shape[0] * 16 + (1 << 16)), 1 << 16)
    out = np.empty(cap, dtype=np.uint8)

    def p32(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    if ang_origin is not None:
        from .decoder import apply_global_motion_q16
        use_gm = gps.global_motion and gbh.lpu_type == 1
        vehicle = np.ascontiguousarray(ref_global, dtype=np.int32)
        if use_gm:
            world = np.ascontiguousarray(
                apply_global_motion_q16(ref_global, gbh.gm_matrix,
                                        gbh.gm_trans, min_pos),
                dtype=np.int32)
            mbs = np.asarray(gbh.motion_block_size, dtype=np.int32)
        else:
            # no GM: slice-local predictor, no LPU flags
            vehicle = np.ascontiguousarray(
                ref_global.astype(np.int64) - origin[None, :],
                dtype=np.int32)
            world = vehicle
            mbs = None
        org32 = np.ascontiguousarray(ang_origin, dtype=np.int32)
        borg = np.ascontiguousarray(origin, dtype=np.int32)
        th = np.ascontiguousarray(gps.angular_theta, dtype=np.int32)
        zl = np.ascontiguousarray(gps.angular_z, dtype=np.int32)
        np_ = np.ascontiguousarray(gps.angular_num_phi,
                                   dtype=np.int32)
        flags = (int(gps.octree_angular_extension)
                 | (int(gps.planar_disabled_idcm_angular) << 1)
                 | (int(gps.inter_idcm) << 2)
                 | (int(gps.one_point_alone_laser_beam) << 3))
        if not hasattr(lib.tmc13ref_encode_octree_inter_ang,
                       "_configured"):
            lib.tmc13ref_encode_octree_inter_ang.argtypes = [
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32),
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32), c.POINTER(c.c_int32),
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_uint8), c.c_int]
            lib.tmc13ref_encode_octree_inter_ang.restype = c.c_int
            lib.tmc13ref_encode_octree_inter_ang._configured = True
        n = lib.tmc13ref_encode_octree_inter_ang(
            p32(pos32), pos32.shape[0],
            p32(vehicle), p32(world), int(vehicle.shape[0]),
            p32(mbs) if mbs is not None else None,
            p32(borg), int(motion_window_size),
            p32(axes), len(axes), p32(gp),
            p32(org32), th.shape[0], p32(th), p32(zl), p32(np_),
            flags,
            out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
        if n < 0:
            raise RuntimeError(
                f"refcodec inter-ang encode failed rc={n}")
        return bytes(out[:n])

    if gps.global_motion and gbh.lpu_type == 1:
        from .decoder import apply_global_motion_q16
        vehicle = np.ascontiguousarray(ref_global, dtype=np.int32)
        world = np.ascontiguousarray(
            apply_global_motion_q16(ref_global, gbh.gm_matrix,
                                    gbh.gm_trans, min_pos),
            dtype=np.int32)
        mbs = np.asarray(gbh.motion_block_size, dtype=np.int32)
        org = np.ascontiguousarray(origin, dtype=np.int32)
        if not hasattr(lib.tmc13ref_encode_octree_inter_gm,
                       "_configured"):
            lib.tmc13ref_encode_octree_inter_gm.argtypes = [
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32),
                c.POINTER(c.c_uint8), c.c_int]
            lib.tmc13ref_encode_octree_inter_gm.restype = c.c_int
            lib.tmc13ref_encode_octree_inter_gm._configured = True
        n = lib.tmc13ref_encode_octree_inter_gm(
            p32(pos32), pos32.shape[0],
            p32(vehicle), p32(world), int(vehicle.shape[0]),
            p32(mbs), p32(org), int(motion_window_size),
            p32(axes), len(axes), p32(gp),
            out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
    else:
        # no GM (or road/obj, compensated by the caller): slice-local
        # predictor handed straight to the octree
        pred = np.ascontiguousarray(
            ref_global.astype(np.int64) - origin[None, :],
            dtype=np.int32)
        if not hasattr(lib.tmc13ref_encode_octree_inter,
                       "_configured"):
            lib.tmc13ref_encode_octree_inter.argtypes = [
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32),
                c.POINTER(c.c_uint8), c.c_int]
            lib.tmc13ref_encode_octree_inter.restype = c.c_int
            lib.tmc13ref_encode_octree_inter._configured = True
        n = lib.tmc13ref_encode_octree_inter(
            p32(pos32), pos32.shape[0],
            p32(pred), int(pred.shape[0]),
            p32(axes), len(axes), p32(gp),
            out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"refcodec inter encode failed rc={n}")
    return bytes(out[:n])


def _encode_brick_native_bipred(positions: np.ndarray,
                                axes: np.ndarray,
                                gps: ref_hls.RefGps,
                                ref_global: np.ndarray,
                                ref2_global: np.ndarray,
                                origin: np.ndarray,
                                bypass_no_update: bool = False,
                                cabac_bypass: bool = False) -> bytes:
    """Encode one B-frame octree brick against two references
    (gbh.biPredictionEnabledFlag, geometry_octree_encoder.cpp:
    1893-1920 with per-node predDir selection :2562-2576).  Both
    references arrive in slice-global STV; without global motion the
    predictors are the origin-shifted clouds (applyGlobalMotion
    skipped, pointPredictorWorld[2] -= geomBoxOrigin)."""
    lib = _load()
    c = ctypes
    pos32 = np.ascontiguousarray(positions, dtype=np.int32)
    gp = geom_params_array(gps, bypass_no_update,
                           cabac_bypass=cabac_bypass)
    cap = max(int(pos32.shape[0] * 16 + (1 << 16)), 1 << 16)
    out = np.empty(cap, dtype=np.uint8)

    def p32(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    pred = np.ascontiguousarray(
        ref_global.astype(np.int64) - origin[None, :], dtype=np.int32)
    pred2 = np.ascontiguousarray(
        ref2_global.astype(np.int64) - origin[None, :],
        dtype=np.int32)
    if not hasattr(lib.tmc13ref_encode_octree_bipred, "_configured"):
        lib.tmc13ref_encode_octree_bipred.argtypes = [
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32),
            c.POINTER(c.c_uint8), c.c_int]
        lib.tmc13ref_encode_octree_bipred.restype = c.c_int
        lib.tmc13ref_encode_octree_bipred._configured = True
    n = lib.tmc13ref_encode_octree_bipred(
        p32(pos32), pos32.shape[0],
        p32(pred), int(pred.shape[0]),
        p32(pred2), int(pred2.shape[0]),
        p32(axes), len(axes), p32(gp),
        out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"refcodec bipred encode failed rc={n}")
    return bytes(out[:n])


def _encode_brick_native_ang(positions: np.ndarray, axes: np.ndarray,
                             gps: ref_hls.RefGps,
                             bypass_no_update: bool = False,
                             box_origin_stv=(0, 0, 0),
                             cabac_bypass: bool = False) -> bytes:
    """Angular octree brick (laser-conditioned planar + angular IDCM;
    native/refcodec.cc tmc13ref_encode_octree_intra_ang)."""
    import ctypes as c
    lib = _load()
    if not hasattr(lib.tmc13ref_encode_octree_intra_ang, "_configured"):
        lib.tmc13ref_encode_octree_intra_ang.argtypes = [
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_uint8), c.c_int]
        lib.tmc13ref_encode_octree_intra_ang.restype = c.c_int
        lib.tmc13ref_encode_octree_intra_ang._configured = True
    pos32 = np.ascontiguousarray(positions, dtype=np.int32)
    gp = geom_params_array(gps, bypass_no_update,
                           cabac_bypass=cabac_bypass)
    # slice-local lidar head (gbh.geomAngularOrigin, hls.h:658);
    # gps.angular_origin is kept in coded xyz order
    origin = (np.asarray(ref_hls.from_xyz(
        1, list(gps.angular_origin)), dtype=np.int64)
        - np.asarray(box_origin_stv, dtype=np.int64))
    org = np.ascontiguousarray(origin, dtype=np.int32)
    th = np.ascontiguousarray(gps.angular_theta, dtype=np.int32)
    zl = np.ascontiguousarray(gps.angular_z, dtype=np.int32)
    nph = np.ascontiguousarray(gps.angular_num_phi, dtype=np.int32)
    flags = (int(gps.octree_angular_extension)
             | (int(gps.planar_disabled_idcm_angular) << 1)
             | (int(gps.inter_idcm) << 2)
             | (int(gps.one_point_alone_laser_beam) << 3))
    cap = max(int(pos32.shape[0] * 16 + (1 << 16)), 1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.tmc13ref_encode_octree_intra_ang(
        pos32.ctypes.data_as(c.POINTER(c.c_int32)), pos32.shape[0],
        axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
        gp.ctypes.data_as(c.POINTER(c.c_int32)),
        org.ctypes.data_as(c.POINTER(c.c_int32)), th.shape[0],
        th.ctypes.data_as(c.POINTER(c.c_int32)),
        zl.ctypes.data_as(c.POINTER(c.c_int32)),
        nph.ctypes.data_as(c.POINTER(c.c_int32)), flags,
        out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"refcodec angular encode failed rc={n}")
    return out[:n].tobytes()


def _round_half_inf(x: float) -> int:
    """roundIntegerHalfInf (motionWip.cpp:458): half away from zero."""
    return int(x + 0.5) if x >= 0 else -int(-x + 0.5)


def parse_motion_file(path: str, qs: float = 1.0):
    """External per-frame global-motion files: 14 floats per frame
    (3x3 matrix, translation, two z thresholds), quantised like the
    reference (MotionParameters::parseFile, geometry_params.h:69-108:
    Q16 matrix with the diagonal coded around 65536; translation and
    thresholds scaled by the coding scale).  Returns
    [(gm_matrix9, gm_trans3, gm_thresh2), ...]."""
    vals = [float(v) for v in open(path).read().split()]
    rows = []
    for i in range(len(vals) // 14):
        v = vals[i * 14:(i + 1) * 14]
        mat = []
        for j in range(9):
            if j % 3 == j // 3:
                mat.append(
                    _round_half_inf((v[j] - 1.0) * 65536) + 65536)
            else:
                mat.append(_round_half_inf(v[j] * 65536))
        trans = tuple(_round_half_inf(v[9 + k] * qs) for k in range(3))
        thresh = (_round_half_inf(v[12] * qs),
                  _round_half_inf(v[13] * qs))
        rows.append((tuple(mat), trans, thresh))
    return rows


def search_global_motion(cur_global: np.ndarray,
                         ref_global: np.ndarray,
                         max_root_dim_log2: int, bsize: int,
                         th_dist: int = 1000,
                         thresh=(0, 0)):
    """Port of the reference's internal LMS global-motion search
    (SearchGlobalMotion, motionWip.cpp:555-650): pick likely-world
    points of the current frame near predictor-occupied cubes, L1-map
    ~100 samples onto the predictor, trim outliers, solve one least-
    squares affine in doubles with the same Gauss pivoting, and
    quantise to the Q16 gm_matrix/gm_trans written in the GBH.
    Inputs are slice-global integer clouds."""
    max_bb = (1 << max_root_dim_log2) - 1
    bn = (max_bb // bsize + 1) if max_bb % bsize else (max_bb // bsize)
    size = bn * bn * bn
    region = np.zeros(size, dtype=bool)
    ref = ref_global.astype(np.int64)
    refd = ref.astype(np.float64)
    # mark cubes around predictor points (PopulatePCLikelyWorld cubic
    # branch; double division truncates toward zero)
    for dm in (th_dist, -th_dist):
        xi = np.trunc((refd[:, 0] + dm) / bsize).astype(np.int64)
        okx = (xi >= 0) & (xi < bn)
        for dn in (th_dist, -th_dist):
            yi = np.trunc((refd[:, 1] + dn) / bsize).astype(np.int64)
            oky = okx & (yi >= 0) & (yi < bn)
            for dk in (th_dist, -th_dist):
                zi = np.trunc((refd[:, 2] + dk) / bsize) \
                    .astype(np.int64)
                ok = oky & (zi >= 0) & (zi < bn)
                region[((xi[ok] * bn + yi[ok]) * bn + zi[ok])] = True
    cur = cur_global.astype(np.int64)
    curd = cur.astype(np.float64)
    ci = np.trunc(curd / bsize).astype(np.int64)
    idx = (ci[:, 0] * bn + ci[:, 1]) * bn + ci[:, 2]
    # NB: the reference guards only idx >= size (out-of-grid x/y can
    # alias in-range indices and that aliasing is normative)
    inb = (idx >= 0) & (idx < size)
    keep = np.zeros(len(cur), dtype=bool)
    keep[inb] = region[idx[inb]]
    top_z, bottom_z = int(thresh[0]), int(thresh[1])
    keep &= (cur[:, 2] < bottom_z) | (cur[:, 2] > top_z)
    pcw = cur[keep]

    mat = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
           [0.0, 0.0, 1.0], [0.0, 0.0, 0.0]]
    if len(pcw) and len(ref):
        jump = 1 + len(pcw) // 100
        targets = pcw[0::jump]
        # map_reference: exact L1 NN over the full predictor
        nn = np.empty(len(targets), dtype=np.int64)
        dmin = np.empty(len(targets), dtype=np.int64)
        for t in range(len(targets)):
            d = np.abs(ref - targets[t][None, :]).sum(axis=1)
            nn[t] = int(np.argmin(d))     # first minimum, like <
            dmin[t] = int(d[nn[t]])
        mean_m = int(dmin.sum())
        sel = dmin * len(targets) <= 2 * mean_m
        p1 = ref[nn[sel]]                 # pcWorldRef
        p2 = targets[sel]                 # pcWorldTarget
        if len(p1):
            mat = _lms3d(p1, p2, max_bb)
    # quantizeGlobalMotion (motionWip.cpp:389-404); the GBH stores
    # the TRANSPOSE of the LMS matrix rows
    scale = 1 << 16
    q = [[0] * 3 for _ in range(4)]
    for l in range(4):
        for c in range(3):
            if l == c:
                q[l][c] = _round_half_inf(
                    (mat[l][c] - 1.0) * scale) + scale
            elif l < 3:
                q[l][c] = _round_half_inf(mat[l][c] * scale)
            else:
                q[l][c] = _round_half_inf(mat[l][c])
    gm_matrix = [0] * 9
    for i in range(3):
        for j in range(3):
            gm_matrix[3 * i + j] = q[j][i]
    gm_trans = (q[3][0], q[3][1], q[3][2])
    return tuple(gm_matrix), gm_trans


def _lms3d(p1: np.ndarray, p2: np.ndarray, max_bb: int):
    """LMS3D (motionWip.cpp:513-647) in doubles with the reference's
    exact accumulation and pivoting order."""
    mv_unity = float(max_bb >> 4)
    m = [[0.0] * 4 for _ in range(4)]
    for row in p1:
        px, py, pz = float(row[0]), float(row[1]), float(row[2])
        m[0][0] += px * px
        m[0][1] += px * py
        m[0][2] += px * pz
        m[0][3] += px * mv_unity
        m[1][1] += py * py
        m[1][2] += py * pz
        m[1][3] += py * mv_unity
        m[2][2] += pz * pz
        m[2][3] += pz * mv_unity
        m[3][3] += mv_unity * mv_unity
    m[1][0] = m[0][1]
    m[2][0] = m[0][2]
    m[2][1] = m[1][2]
    m[3][0] = m[0][3]
    m[3][1] = m[1][3]
    m[3][2] = m[2][3]
    inv = [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0],
           [0, 0, 0, 1.0]]
    for pivot in range(3):
        vp = m[pivot][pivot]
        for l in range(pivot + 1, 4):
            f = -m[l][pivot] / vp
            for c in range(4):
                m[l][c] += m[pivot][c] * f
                inv[l][c] += inv[pivot][c] * f
    for pivot in range(3, 0, -1):
        vp = m[pivot][pivot]
        for l in range(pivot - 1, -1, -1):
            f = -m[l][pivot] / vp
            for c in range(4):
                m[l][c] += m[pivot][c] * f
                inv[l][c] += inv[pivot][c] * f
    for pivot in range(4):
        f = 1.0 / m[pivot][pivot]
        for c in range(4):
            inv[pivot][c] *= f
    r = [[0.0] * 3 for _ in range(4)]
    for i in range(len(p1)):
        rx, ry, rz = (float(p1[i][0]), float(p1[i][1]),
                      float(p1[i][2]))
        tx, ty, tz = (float(p2[i][0]), float(p2[i][1]),
                      float(p2[i][2]))
        r[0][0] += tx * rx
        r[1][0] += tx * ry
        r[2][0] += tx * rz
        r[3][0] += tx * mv_unity
        r[0][1] += ty * rx
        r[1][1] += ty * ry
        r[2][1] += ty * rz
        r[3][1] += ty * mv_unity
        r[0][2] += tz * rx
        r[1][2] += tz * ry
        r[2][2] += tz * rz
        r[3][2] += tz * mv_unity
    t = [[0.0] * 3 for _ in range(4)]
    for l in range(4):
        for c in range(3):
            t[l][c] = (inv[l][0] * r[0][c] + inv[l][1] * r[1][c]
                       + inv[l][2] * r[2][c] + inv[l][3] * r[3][c])
    for c in range(3):
        t[3][c] *= mv_unity
    # lambda = 1: penalisation terms cancel; initial GM is identity,
    # so the composed matrix IS t (deformation) + t[3] (translation)
    return [[t[0][0], t[0][1], t[0][2]],
            [t[1][0], t[1][1], t[1][2]],
            [t[2][0], t[2][1], t[2][2]],
            [t[3][0], t[3][1], t[3][2]]]


def _ceillog2(x: int) -> int:
    return max(int(x - 1).bit_length(), 0)


def _encode_predgeom_brick_native(stv: np.ndarray, gps: ref_hls.RefGps,
                                  origin_stv, root_log2,
                                  bypass_no_update: bool = True,
                                  max_pts_per_tree: int = 1100000,
                                  cabac_bypass: bool = False):
    """Angular predictive-geometry brick, byte-identical to tmc3
    (native/refpredgeom.cc tmc13ref_encode_predgeom).  Returns
    (aec_bytes, pgeom_resid_abs_log2_bits, pgeom_min_radius)."""
    import ctypes as c
    lib = _load()
    if not hasattr(lib.tmc13ref_encode_predgeom, "_configured"):
        lib.tmc13ref_encode_predgeom.argtypes = [
            c.POINTER(c.c_int32), c.c_int, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_uint8), c.c_int]
        lib.tmc13ref_encode_predgeom.restype = c.c_int
        lib.tmc13ref_encode_predgeom._configured = True
    params = np.array([
        1 if gps.unique_points else 0,
        1,                                   # angular
        1 if gps.azimuth_scaling_enabled else 0,
        1 if gps.residual2_disabled else 0,
        len(gps.angular_theta),
        int(origin_stv[0]), int(origin_stv[1]), int(origin_stv[2]),
        gps.azimuth_scale_log2_minus11 + 12,
        gps.azimuth_speed_minus1 + 1,
        gps.radius_inv_scale_log2,
        gps.predgeom_max_pred_index,
        gps.predgeom_radius_threshold,
        gps.resr_qphi_threshold if gps.resr_qphi_threshold_present else 0,
        0, 0, 0, 0,
        1 if bypass_no_update else 0,
        max_pts_per_tree,
        # sanitizer: maxPredIdxTested defaults to maxPredIdx
        # (TMC3.cpp:1975-1979)
        gps.predgeom_max_pred_index,
        int(root_log2[0]), int(root_log2[1]), int(root_log2[2]),
        1 if cabac_bypass else 0,
    ], dtype=np.int32)
    th = np.ascontiguousarray(gps.angular_theta, dtype=np.int32)
    zl = np.ascontiguousarray(gps.angular_z, dtype=np.int32)
    pts = np.ascontiguousarray(stv, dtype=np.int32)
    cap = max(int(pts.shape[0]) * 24 + (1 << 16), 1 << 16)
    out = np.empty(cap, dtype=np.uint8)

    def p32(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    n = lib.tmc13ref_encode_predgeom(
        p32(pts), pts.shape[0], p32(params), p32(th), p32(zl),
        out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"refpredgeom encode failed rc={n}")
    return (out[:n].tobytes(),
            tuple(int(v) for v in params[14:17]), int(params[17]))


def _encode_trisoup_brick_native(stv: np.ndarray, axes: np.ndarray,
                                 gps: ref_hls.RefGps,
                                 ts_log2: int,
                                 slice_max_points: int = 1_100_000,
                                 improved_vertex: bool = True,
                                 node_unique_dse: bool = True,
                                 halo: bool = True,
                                 adaptive_halo: bool = True,
                                 fine_ray: bool = True,
                                 face_vertex: bool = True,
                                 centroid_residual: bool = True,
                                 bypass_no_update: bool = True):
    """Encode one trisoup geometry brick, byte-identical to the
    reference encoder (encodeGeometryTrisoup,
    tmc3/geometry_trisoup_encoder.cpp:100-246): octree
    phase down to the trisoup node size, vertex determination with the
    improved per-node distance search, vertex/centroid/face entropy
    stages and the adaptive sampling loop.

    Returns (aec_payload, header_fields, recon_points) where
    header_fields carries num_unique_segments + the chosen sampling
    and recon_points is the reconstructed cloud (slice-local STV, in
    the reference's reconstruction order) whose count goes in the
    footer."""
    lib = _load()
    c = ctypes

    def p32(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    def pu8(a):
        return a.ctypes.data_as(c.POINTER(c.c_uint8))

    if not hasattr(lib.tmc13ref_encode_octree_trisoup, "_configured"):
        lib.tmc13ref_encode_octree_trisoup.argtypes = [
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.c_int, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.c_int, c.POINTER(c.c_int32),
            c.POINTER(c.c_void_p)]
        lib.tmc13ref_encode_octree_trisoup.restype = c.c_int
        lib.tsgeom_set_points.argtypes = [
            c.c_void_p, c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
        lib.tsgeom_set_sampling.argtypes = [c.c_void_p, c.c_int]
        lib.tsgeom_enc_verts.argtypes = [
            c.c_void_p, c.c_int, c.c_int, c.c_float,
            c.POINTER(c.c_uint8), c.POINTER(c.c_int32),
            c.POINTER(c.c_int32)]
        lib.tsgeom_enc_verts.restype = c.c_int
        lib.tsgeom_enc_drifts.argtypes = [c.c_void_p,
                                          c.POINTER(c.c_int32)]
        lib.tsgeom_enc_drifts.restype = c.c_int
        lib.tsgeom_enc_faces.argtypes = [c.c_void_p, c.c_int,
                                         c.POINTER(c.c_uint8)]
        lib.tsgeom_enc_faces.restype = c.c_int
        lib.tsref_enc_verts.argtypes = [
            c.c_void_p, c.POINTER(c.c_uint16), c.POINTER(c.c_int32),
            c.c_int, c.c_int, c.POINTER(c.c_uint8),
            c.POINTER(c.c_uint8), c.POINTER(c.c_int32)]
        lib.tsref_enc_verts.restype = c.c_int
        lib.tsref_enc_centroids.argtypes = [
            c.c_void_p, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.c_int]
        lib.tsref_enc_faces.argtypes = [c.c_void_p,
                                        c.POINTER(c.c_uint8), c.c_int]
        lib.tsref_enc_finish.argtypes = [c.c_void_p,
                                         c.POINTER(c.c_uint8), c.c_int]
        lib.tsref_enc_finish.restype = c.c_int
        lib.tmc13ref_encode_octree_trisoup._configured = True

    pos32 = np.ascontiguousarray(stv, dtype=np.int32)
    npts = int(pos32.shape[0])
    gp = geom_params_array(gps, bypass_no_update)
    cap = npts + 16
    out_leaves = np.empty((cap, 5), dtype=np.int32)
    out_order = np.empty(npts, dtype=np.int32)
    hnd = c.c_void_p()
    n = lib.tmc13ref_encode_octree_trisoup(
        p32(pos32), npts, p32(axes), len(axes), ts_log2, p32(gp),
        p32(out_leaves), cap, p32(out_order), c.byref(hnd))
    if n < 0:
        raise RuntimeError(f"trisoup octree phase (encode) rc={n}")
    leaves5 = out_leaves[:n]
    leaves = np.ascontiguousarray(leaves5[:, :3])
    leaf_start = np.ascontiguousarray(leaves5[:, 3])
    leaf_end = np.ascontiguousarray(leaves5[:, 4])
    order = out_order

    w = 1 << ts_log2
    # estimatedSampling + distanceSearchEncoder (encoder.cpp ref
    # geometry_trisoup_encoder.cpp:134-148), float32 arithmetic
    bit_dropped = 0       # trisoup_vertex_quant_bits=0 -> full bits
    est = np.float32(1.0)
    dse = 1
    if improved_vertex:
        est = np.sqrt(np.float32(n) / np.float32(npts)) * np.float32(w)
        est = max(np.float32(1.0), est)
        v = np.float32(est) + np.float32(0.1)
        dse = (1 << max(0, bit_dropped - 2)) - 1 + int(np.floor(v + 0.5))
        dse = max(1, min(8, dse))

    from ..ops.trisoup_ref import trisoup_neighbours
    feats = trisoup_neighbours(leaves, w)
    neighb = np.ascontiguousarray(feats["neighb"])
    pattern = np.ascontiguousarray(feats["pattern"])
    nseg = int(neighb.shape[0])
    nbits = ts_log2 - bit_dropped

    # non-cubic boundary nodes: the slice bbox is signalled in the GBH
    # and clips boundary-node widths (encoder.cpp:966-992; clipping
    # active only when the respective _bits field is coded,
    # nonCubicNode geometry_trisoup_decoder.cpp:532-550)
    mask = w - 1
    src_min = stv.min(axis=0).astype(np.int64)
    src_max = stv.max(axis=0).astype(np.int64)
    sl_pos = np.zeros(3, dtype=np.int64)
    sl_width = np.zeros(3, dtype=np.int64)
    pos_bits = width_bits = 0
    if gps.non_cubic_node_start_edge:
        sl_pos = src_min
        if np.any(src_min & mask):
            pos_bits = max(int(sl_pos.max()).bit_length(), 1)
    if gps.non_cubic_node_end_edge:
        sl_width = src_max - sl_pos
        if np.any(src_max & mask):
            width_bits = max(int(sl_width.max()).bit_length(), 1)
    flag_n = int(gps.non_cubic_node_start_edge and pos_bits > 0)
    flag_f = int(gps.non_cubic_node_end_edge and width_bits > 0)
    bb_min = sl_pos.astype(np.int32)
    bb_max = (sl_pos + sl_width).astype(np.int32)
    gh = lib.tsgeom_open(
        p32(leaves), n, w, bit_dropped, flag_n, flag_f, p32(bb_min),
        p32(bb_max), 1, int(halo), int(adaptive_halo), int(fine_ray),
        int(face_vertex), int(centroid_residual))
    ts = lib.tsref_open(hnd)
    try:
        pts_sorted = np.ascontiguousarray(pos32[order])
        lib.tsgeom_set_points(gh, p32(pts_sorted), npts,
                              p32(leaf_start), p32(leaf_end))
        segind = np.zeros(nseg, dtype=np.uint8)
        vert32 = np.zeros(nseg, dtype=np.int32)
        lib.tsgeom_enc_verts(gh, dse, int(node_unique_dse),
                             c.c_float(float(est)), pu8(segind),
                             p32(vert32), None)
        vert = np.clip(vert32, 0, None).astype(np.uint8)
        seg2v = np.zeros(nseg, dtype=np.int32)
        lib.tsref_enc_verts(ts, neighb.ctypes.data_as(
            c.POINTER(c.c_uint16)), p32(pattern), nseg, nbits,
            pu8(segind), pu8(vert), p32(seg2v))

        uniq_vert = np.where(segind > 0, vert32, -1).astype(np.int32)
        nelig = lib.tsgeom_set_verts(gh, p32(uniq_vert))
        cctx = np.zeros((max(nelig, 1), 5), dtype=np.int32)
        lib.tsgeom_get_cctx(gh, p32(cctx))
        driftq = np.zeros(max(nelig, 1), dtype=np.int32)
        if nelig and centroid_residual:
            lib.tsgeom_enc_drifts(gh, p32(driftq))
        ncand = lib.tsgeom_apply_drifts(gh, p32(driftq))
        conn = np.zeros(max(ncand, 1), dtype=np.uint8)
        if face_vertex and ncand:
            lib.tsgeom_enc_faces(gh, dse, pu8(conn))

        # adaptive sampling: smallest subsample whose reconstruction
        # fits the slice point budget (encoder :215-230; the budget is
        # sliceMaxPointsTrisoup, encoder.cpp:1444)
        sampling = 1
        npts_rec = 0
        for ss in range(1, w + 1):
            sampling = ss
            lib.tsgeom_set_sampling(gh, ss)
            npts_rec = lib.tsgeom_reconstruct(gh)
            if npts_rec <= slice_max_points:
                break
        recon = np.empty((npts_rec, 3), dtype=np.int32)
        lib.tsgeom_get_points(gh, p32(recon))

        if centroid_residual and nelig:
            lib.tsref_enc_centroids(ts, p32(cctx), p32(driftq), nelig)
        if face_vertex and ncand:
            lib.tsref_enc_faces(ts, pu8(conn), ncand)
        buf_cap = npts * 16 + (1 << 16)
        buf = np.empty(buf_cap, dtype=np.uint8)
        nb = lib.tsref_enc_finish(ts, pu8(buf), buf_cap)
        if nb < 0:
            raise RuntimeError("trisoup payload overflow")
    finally:
        lib.tsref_close(ts)
        lib.tsgeom_close(gh)

    fields = dict(num_unique_segments=nseg, trisoup_sampling=sampling,
                  trisoup_node_size_log2=ts_log2,
                  trisoup_vertex_quant_bits=0,
                  trisoup_centroid_residual=centroid_residual,
                  trisoup_face_vertex=face_vertex,
                  trisoup_halo=halo,
                  trisoup_adaptive_halo=adaptive_halo,
                  trisoup_fine_ray=fine_ray,
                  slice_bb_pos_bits=pos_bits,
                  slice_bb_pos=tuple(int(v) for v in sl_pos),
                  slice_bb_width_bits=width_bits,
                  slice_bb_width=tuple(int(v) for v in sl_width))
    return buf[:nb].tobytes(), fields, recon.astype(np.int64)


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


def encode_stream(positions: np.ndarray,
                  unique_points: bool = True,
                  neighbour_avail_boundary_log2: int = 8,
                  adjacent_child_contextualization: bool = True,
                  axis_order: int = 1,
                  frame_ctr_bits: int = 1,
                  planar: bool = False,
                  qtbt: bool = True,
                  idcm: int = 0,
                  colors: np.ndarray = None,
                  reflectances: np.ndarray = None,
                  attr_qp: int = 34,
                  attr_bitdepth: int = 8,
                  integer_haar: bool = False,
                  trisoup_node_size_log2: int = 0,
                  bypass_no_update: bool = True,
                  num_entropy_streams: int = 1,
                  angular: bool = False,
                  angular_head=(0, 0, 0),
                  lasers_theta=None,
                  lasers_z=None,
                  lasers_num_phi=None,
                  predgeom: bool = False,
                  cabac_bypass: bool = False,
                  bitwise_occupancy: bool = True,
                  attr_qp_region=None) -> bytes:
    """Encode one frame of non-negative integer XYZ positions into a
    complete reference-syntax TLV stream (SPS + GPS + geometry brick,
    plus APS + RAHT attribute brick when colors/reflectances given).

    colors: (N, 3) GBR values in the CODED colour space aligned with
    `positions` rows (the caller converts colour spaces; the stream's
    cicp is not written, matching tmc3 --convertPlyColourspace=0).
    The attribute payload is byte-identical to the reference encoder's
    for the same configuration (native/refattr.cc encoder).

    With unique_points the duplicates are merged exactly as the
    reference encoder does before coding.
    """
    pos = np.asarray(positions, dtype=np.int64)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError("positions must be (N, 3)")
    if pos.size and pos.min() < 0:
        raise ValueError("positions must be non-negative")
    # sequence bounding box origin: the input bbox min is recorded in
    # the SPS and subtracted before coding (encoder.cpp:118-156;
    # autoSeqBbox, seq scale 1, global scale 1)
    seq_origin = (pos.min(axis=0) if pos.size
                  else np.zeros(3, dtype=np.int64))
    pos = pos - seq_origin
    attr_vals = colors if colors is not None else reflectances
    if unique_points:
        # dedup preserving FIRST-OCCURRENCE order like the reference
        # (reducePointSet, pointset_processing.cpp:55): the input order
        # is normatively visible through the angular IDCM two-point
        # order (unstable counting sort, PCCMisc.h:271)
        codes_in = (pos[:, 0] << 42) | (pos[:, 1] << 21) | pos[:, 2]
        _, first = np.unique(codes_in, return_index=True)
        first.sort()
        pos = pos[first]
        if attr_vals is not None:
            attr_vals = np.asarray(attr_vals)[first]
    # xyz -> stv (identity for axis_order 1)
    stv = np.stack(ref_hls.from_xyz(
        axis_order, [pos[:, 0], pos[:, 1], pos[:, 2]]), axis=1)
    # per-axis root sizes (encoder.cpp:1373: ceillog2(max(2, whd)))
    whd = (stv.max(axis=0) + 1) if stv.size else np.array([1, 1, 1])
    ts_log2 = trisoup_node_size_log2
    root = [max(_ceillog2(max(2, int(v))), ts_log2) for v in whd]
    if not qtbt:
        root = [max(root)] * 3
    if ts_log2:
        # trisoup: qtbt-first override (geometry_octree.cpp:114-118),
        # levels truncated at the trisoup node size
        axes = np.asarray(qtbt_axis_list(
            root, qtbt, max_num_qtbt_before_ot=max(root) - min(root),
            min_qtbt_size_log2=0, stop_log2=ts_log2), dtype=np.int32)
    elif angular:
        # angular QTBT tweak thresholds at coding scale 1
        # (TMC3.cpp:1957-1960: 8 + log2(scale), 1 + log2(scale))
        axes = np.asarray(qtbt_axis_list(
            root, qtbt, angular_tweak=True, ang_max_v=8,
            ang_max_diff_z=1), dtype=np.int32)
    else:
        axes = np.asarray(qtbt_axis_list(root, qtbt), dtype=np.int32)

    # sanitizer: separate bypass-bin coding only without the chunked
    # bypass stream (TMC3.cpp:2021-2023)
    if cabac_bypass:
        bypass_no_update = False
    sps = ref_hls.RefSps(
        main_profile_compat=0, level=0, sps_id=0,
        frame_ctr_bits=frame_ctr_bits, slice_tag_bits=0,
        geometry_axis_order=axis_order,
        bbox_origin=tuple(int(v) for v in seq_origin))
    sps.cabac_bypass_stream_enabled = cabac_bypass
    # tmc3 default codes bypass bins without probability update
    # (TMC3.cpp:824-827)
    sps.bypass_bin_coding_without_prob_update = bypass_no_update
    if attr_vals is not None:
        dims = 3 if colors is not None else 1
        sps.num_attrs = 1
        sps.attr_dims = [dims]
        sps.attr_bitdepths = [attr_bitdepth]
        # KnownAttributeLabel (hls.h): 0 = colour, 1 = reflectance
        sps.attr_labels = [0 if colors is not None else 1]
        sps.attr_cicp_matrix = [None]
    gps = ref_hls.RefGps(
        gps_id=0, sps_id=0, geom_box_log2_scale_present=True,
        qtbt_enabled=qtbt,
        unique_points=unique_points,
        inferred_direct_coding_mode=idcm,
        joint_2pt_idcm=bool(idcm),
        idcm_rate_minus1=31 if idcm else 0,
        neighbour_avail_boundary_log2_minus1=(
            neighbour_avail_boundary_log2 - 1),
        # bitwise_occupancy=0 signals the (vestigial) DualLut bytewise
        # coder; this reference version never dispatches on it, so the
        # brick is the normal bitwise coding with planar off
        # (TMC3.cpp:1727-1731 sanitizer)
        bitwise_occupancy=bitwise_occupancy,
        adjacent_child_contextualization=(
            adjacent_child_contextualization),
        planar_enabled=planar,
        # CTC planar configuration (thresholds from TMC3.cpp defaults;
        # depth eligibility + dynamic OBUF + multiple planar as the
        # reference encoder derives for non-angular content)
        planar_threshold0=77, planar_threshold1=99,
        planar_threshold2=113,
        depth_planar_eligibility=planar,
        planar_dynamic_obuf_eligibility=planar,
        multiple_planar=planar,
        trisoup_enabled=bool(ts_log2),
        # tmc3 defaults (TMC3.cpp:977-981): non-cubic boundary nodes
        # on both slice edges when trisoup is active
        non_cubic_node_start_edge=bool(ts_log2),
        non_cubic_node_end_edge=bool(ts_log2))

    if angular and idcm == 1:
        # tmc3 sanitizer: rate-limited IDCM is silently disabled with
        # angular unless planarModeIdcmUse > 0 (TMC3.cpp sanitizer)
        idcm = 0
        gps.inferred_direct_coding_mode = 0
        gps.joint_2pt_idcm = False
        gps.idcm_rate_minus1 = 0
        gps.planar_disabled_idcm_angular = False
    if angular:
        # tmc3 laser table quantisation at coding scale 1
        # (TMC3.cpp:1925-1945): theta = round(tan * 2^18),
        # z = round(z * scale * 2^3); head relative to the sequence
        # origin (encoder.cpp:168-169)
        gps.angular_enabled = True
        gps.angular_origin = tuple(
            int(v) - int(o) for v, o in zip(angular_head, seq_origin))
        gps.angular_theta = [int(round(v * (1 << 18)))
                             for v in lasers_theta]
        gps.angular_z = [int(round(v * 8)) for v in lasers_z]
        gps.angular_num_phi = [int(v) for v in lasers_num_phi]
        gps.octree_angular_extension = True
        gps.planar_disabled_idcm_angular = bool(planar and idcm)
        # the sanitizer withholds dynamic-OBUF planar with angular
        # (flag absent from the syntax, parse default False)
        gps.planar_dynamic_obuf_eligibility = False

    if predgeom:
        # predictive geometry: angular tool set with the tmc3 CLI
        # defaults (TMC3.cpp:1045-1102,1641 speed decrement; sanitizer
        # 1970-1979 radius threshold scaling)
        if not angular:
            raise NotImplementedError(
                "refSyntax predgeom requires the angular tool set")
        gps.predgeom_enabled = True
        gps.planar_enabled = False
        gps.inferred_direct_coding_mode = 0
        gps.joint_2pt_idcm = False
        gps.azimuth_scale_log2_minus11 = 5
        gps.azimuth_speed_minus1 = 362
        gps.radius_inv_scale_log2 = 0
        gps.residual2_disabled = False
        gps.azimuth_scaling_enabled = True
        gps.predgeom_max_pred_index = 3
        gps.predgeom_radius_threshold = 2048 >> gps.radius_inv_scale_log2
        gps.resr_qphi_threshold_present = False

    if ts_log2:
        aec, tfields, recon = _encode_trisoup_brick_native(
            stv, axes, gps, ts_log2, bypass_no_update=bypass_no_update)
        gbh = ref_hls.RefGbh(
            gps_id=0, slice_id=0, slice_tag=0, frame_ctr_lsb=0,
            geom_box_log2_scale=0, box_origin_stv=(0, 0, 0),
            tree_lvl_coded_axis_list=list(axes),
            num_points=int(recon.shape[0]), **tfields)
    elif predgeom:
        # per-axis root sizes regardless of qtbt (encoder.cpp:1386
        # applies the cubic override only to octree bricks)
        root_pg = [_ceillog2(max(2, int(v))) for v in whd]
        origin_stv = ref_hls.from_xyz(axis_order,
                                      list(gps.angular_origin))
        aec, residbits, minr = _encode_predgeom_brick_native(
            stv, gps, origin_stv, root_pg,
            bypass_no_update=bypass_no_update,
            cabac_bypass=cabac_bypass)
        gbh = ref_hls.RefGbh(
            gps_id=0, slice_id=0, slice_tag=0, frame_ctr_lsb=0,
            geom_box_log2_scale=0, box_origin_stv=(0, 0, 0),
            pgeom_resid_abs_log2_bits=residbits,
            pgeom_min_radius=minr,
            num_points=int(pos.shape[0]))
    else:
        scm1 = max(0, min(num_entropy_streams, len(axes)) - 1)
        if cabac_bypass and scm1:
            raise NotImplementedError(
                "cabac bypass stream with multiple entropy streams")
        if angular:
            aec = _encode_brick_native_ang(
                stv, axes, gps, bypass_no_update=bypass_no_update,
                cabac_bypass=cabac_bypass)
        else:
            aec = _encode_brick_native(stv, axes, gps,
                                       bypass_no_update=bypass_no_update,
                                       stream_cnt_minus1=scm1,
                                       cabac_bypass=cabac_bypass)
        gbh = ref_hls.RefGbh(
            gps_id=0, slice_id=0, slice_tag=0, frame_ctr_lsb=0,
            geom_box_log2_scale=0, box_origin_stv=(0, 0, 0),
            tree_lvl_coded_axis_list=list(axes),
            geom_stream_cnt_minus1=scm1,
            num_points=int(pos.shape[0]))
    brick = ref_hls.write_gbh(sps, gps, gbh, aec)

    stream = (ref_hls.write_ref_tlv(ref_hls.T_SPS,
                                    ref_hls.write_sps(sps))
              + ref_hls.write_ref_tlv(ref_hls.T_GPS,
                                      ref_hls.write_gps(gps)))

    if attr_vals is not None:
        # tmc3 defaults (TMC3.cpp:1290-1319; search range sanitised to
        # the level limit, encoder.cpp:808)
        aps = ref_hls.RefAps(
            aps_id=0, sps_id=0, attr_encoding=ref_hls.ATTR_RAHT,
            init_qp_minus4=attr_qp - 4,
            raht_prediction_enabled=True,
            raht_prediction_threshold0=2, raht_prediction_threshold1=6,
            integer_haar=integer_haar, raht_extension=True,
            raht_subnode_prediction=True,
            raht_prediction_weights=[9, 3, 1, 5, 2],
            raht_prediction_search_range=1100000)
        stream += ref_hls.write_ref_tlv(ref_hls.T_APS,
                                        ref_hls.write_aps(aps))

    stream += ref_hls.write_ref_tlv(ref_hls.T_GEOM_BRICK, brick)

    if attr_vals is not None:
        # the attribute brick codes against the DECODED positions in
        # decode order with the slice origin added; re-derive them
        # (decoder.cpp:921-922) and map src attributes by position
        from . import decoder as refdec
        gbh_parsed = ref_hls.parse_gbh(sps, gps, brick)
        dec_pos = refdec.decode_geometry_brick(sps, gps, gbh_parsed,
                                               brick)
        av0 = np.asarray(attr_vals, dtype=np.int32)
        if av0.ndim == 1:
            av0 = av0[:, None]
        if ts_log2:
            # lossy geometry: recolour onto the reconstruction
            # (reference transferAttributes, pointset_processing.cpp)
            from ..models.pointcloud import PointCloud
            from ..ops import recolour as rc
            src_cloud = PointCloud(
                positions=stv.astype(np.int64),
                colors=(av0.astype(np.uint16)
                        if av0.shape[1] == 3 else None),
                reflectances=(av0[:, 0].astype(np.uint16)
                              if av0.shape[1] == 1 else None))
            tgt = rc.recolour(src_cloud, dec_pos.astype(np.int64))
            av = np.asarray(tgt.colors if av0.shape[1] == 3
                            else tgt.reflectances[:, None],
                            dtype=np.int32)
        else:
            k_dec = ((dec_pos[:, 0] << 42) | (dec_pos[:, 1] << 21)
                     | dec_pos[:, 2])
            k_src = (stv[:, 0] << 42) | (stv[:, 1] << 21) | stv[:, 2]
            os_ = np.argsort(k_src)
            src_row = os_[np.searchsorted(k_src[os_], k_dec)]
            av = av0[src_row]
        regions = [attr_qp_region] if attr_qp_region else None
        attr_aec, _, _, _ = encode_attr_brick_native(
            sps, aps, dec_pos, av, qp_regions=regions)
        abrick = ref_hls.write_abh(aps, 0, 0, attr_aec,
                                   qp_regions=regions,
                                   axis_order=axis_order)
        stream += ref_hls.write_ref_tlv(ref_hls.T_ATTR_BRICK, abrick)

    return stream


def encode_attr_brick_native(sps, aps, positions_stv: np.ndarray,
                             attrs: np.ndarray, attr_ref=None,
                             qp_regions=None):
    """RAHT-encode attributes aligned to decode-order positions.
    Returns (AEC payload bytes, reconstructed attributes in the same
    row order, layer code modes, quantised filter taps).  With
    ``attr_ref`` (previous frame's coding positions + reconstructed
    attributes) the encoder runs the reference's per-layer inter/intra
    RDO and filter estimation (RAHT.cpp encoder inter paths).
    ``qp_regions``: optional region QP boxes in ABH form
    [(origin_stv, size_stv, (off_luma, off_chroma))] — the caller must
    also signal them via write_abh(qp_regions=...)."""
    from ..utils import morton
    from .decoder import _load

    lib = _load()
    c = ctypes
    if not hasattr(lib.tmc13ref_encode_raht_attr, "_configured"):
        lib.tmc13ref_encode_raht_attr.argtypes = [
            c.POINTER(c.c_int64), c.c_int, c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int,
            c.c_int, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_uint8), c.c_int,
            c.POINTER(c.c_int32)]    # pointQp region offsets, nullable
        lib.tmc13ref_encode_raht_attr.restype = c.c_int
        lib.tmc13ref_encode_raht_attr._configured = True
        lib.tmc13ref_encode_raht_attr_inter.argtypes = [
            c.POINTER(c.c_int64), c.c_int, c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int,
            c.c_int, c.POINTER(c.c_int32),
            c.POINTER(c.c_int64), c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_uint8), c.c_int]
        lib.tmc13ref_encode_raht_attr_inter.restype = c.c_int

    dims = attrs.shape[1]
    bitdepth = sps.attr_bitdepths[0]
    codes = morton.encode(np.ascontiguousarray(positions_stv,
                                               dtype=np.int64))
    order = np.argsort(codes, kind="stable")
    codes_sorted = np.ascontiguousarray(codes[order])
    attrs_sorted = np.ascontiguousarray(attrs[order], dtype=np.int32)

    layers = [(aps.init_qp_minus4 + 4, aps.chroma_qp_offset)]
    qp_arr = np.asarray(layers, dtype=np.int32).reshape(-1)
    params = np.zeros(40, dtype=np.int32)
    params[0] = 1 if aps.raht_prediction_enabled else 0
    params[1] = 1 if aps.integer_haar else 0
    params[2] = aps.raht_prediction_threshold0
    params[3] = aps.raht_prediction_threshold1
    params[4] = 1 if aps.raht_subnode_prediction else 0
    params[5] = aps.raht_prediction_search_range
    params[6] = 1 if aps.raht_extension else 0
    params[7] = 1 if sps.bypass_bin_coding_without_prob_update else 0
    params[8:27] = aps.pred_weight_parent()
    params[27:39] = aps.pred_weight_child()
    params[39] = 1 if sps.cabac_bypass_stream_enabled else 0

    n = len(codes_sorted)
    rec = np.empty((n, dims), dtype=np.int32)
    cap = n * dims * 8 + 4096
    out = np.empty(cap, dtype=np.uint8)
    modes_out = taps_out = None
    if attr_ref is not None:
        ref_pos, ref_attr = attr_ref
        rcodes = morton.encode(np.ascontiguousarray(ref_pos,
                                                    dtype=np.int64))
        rorder = np.argsort(rcodes, kind="stable")
        rcodes_s = np.ascontiguousarray(rcodes[rorder])
        rattr_s = np.ascontiguousarray(
            np.asarray(ref_attr, dtype=np.int32)[rorder].reshape(-1))
        iparams = np.asarray(
            [aps.raht_inter_depth_minus1 + 1,
             1 if aps.raht_send_inter_filters else 0,
             aps.raht_inter_skip_layers,
             1 if aps.raht_enable_code_layer else 0, 0, 0],
            dtype=np.int32)
        modes = np.zeros(64, dtype=np.int32)
        taps = np.zeros(64, dtype=np.int32)
        counts = np.zeros(2, dtype=np.int32)
        rc = lib.tmc13ref_encode_raht_attr_inter(
            codes_sorted.ctypes.data_as(c.POINTER(c.c_int64)), n, dims,
            attrs_sorted.ctypes.data_as(c.POINTER(c.c_int32)),
            qp_arr.ctypes.data_as(c.POINTER(c.c_int32)), len(layers),
            bitdepth, params.ctypes.data_as(c.POINTER(c.c_int32)),
            rcodes_s.ctypes.data_as(c.POINTER(c.c_int64)),
            rattr_s.ctypes.data_as(c.POINTER(c.c_int32)),
            int(rcodes_s.shape[0]),
            iparams.ctypes.data_as(c.POINTER(c.c_int32)),
            modes.ctypes.data_as(c.POINTER(c.c_int32)),
            taps.ctypes.data_as(c.POINTER(c.c_int32)),
            counts.ctypes.data_as(c.POINTER(c.c_int32)),
            rec.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
        if rc >= 0:
            modes_out = [int(v) for v in modes[:counts[0]]]
            taps_out = [int(v) for v in taps[:counts[1]]]
    else:
        pqp_ptr = None
        if qp_regions:
            from .decoder import _point_region_qps

            class _Abh:
                pass
            _a = _Abh()
            _a.qp_regions = qp_regions
            pqp = _point_region_qps(_a, positions_stv, order)
            pqp_ptr = pqp.ctypes.data_as(c.POINTER(c.c_int32))
        rc = lib.tmc13ref_encode_raht_attr(
            codes_sorted.ctypes.data_as(c.POINTER(c.c_int64)), n, dims,
            attrs_sorted.ctypes.data_as(c.POINTER(c.c_int32)),
            qp_arr.ctypes.data_as(c.POINTER(c.c_int32)), len(layers),
            bitdepth, params.ctypes.data_as(c.POINTER(c.c_int32)),
            rec.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_uint8)), cap, pqp_ptr)
    if rc < 0:
        raise RuntimeError(f"refattr encode failed rc={rc}")
    rec_out = np.empty_like(rec)
    rec_out[order] = rec
    return bytes(out[:rc]), rec_out, modes_out, taps_out


def bipred_coding_schedule(frame_count: int, random_access_period: int,
                           period: int):
    """The IBBB (biPredictionEnabledFlag=1) GOF coding order: a list
    of (frame_index, code_as_b) in CODING order, mirroring
    SequenceEncoder::compress + compressOneGOF (TMC3.cpp:2171-2358):
    I/P frames land on multiples of biPredictionPeriod inside each
    random-access GOF and are coded first; the frames between them
    are B-frames coded against the surrounding I/P pair.  Without
    global motion biPredictionEligibility is unconditionally true
    (encoder.cpp:917-918)."""
    schedule = []
    pre_ip = -1
    coded_gof = False
    for gof_start in range(0, frame_count, random_access_period):
        gof_size_p1 = (frame_count - gof_start
                       if gof_start + random_access_period
                       >= frame_count
                       else random_access_period + 1)
        ip = list(range(0, gof_size_p1, period))
        if ip[-1] != gof_size_p1 - 1:
            ip.append(gof_size_p1 - 1)
        for i in range(1 if coded_gof else 0, len(ip)):
            cur = ip[i] + gof_start
            if pre_ip == -1:
                schedule.append((cur, False))
            else:
                schedule.append((cur, False))
                for f in range(pre_ip + 1, cur):
                    schedule.append((f, True))
            pre_ip = cur
        coded_gof = True
    return schedule


def _encode_bipred_stream(frames, sps, gps, seq_origin,
                          unique_points: bool, qtbt: bool,
                          max_points_per_slice: int,
                          random_access_period: int, period: int,
                          bypass_no_update: bool,
                          cabac_bypass: bool) -> bytes:
    """Geometry-only bi-prediction (IBBB GOF) stream emission.

    Reference-frame bookkeeping mirrors encoder.cpp: after a non-B
    frame its reconstruction becomes predPointCloud2 (:578-580); at
    the start of the next non-B frame _refFrame takes the previous
    predPointCloud2 (:528-533); after a B frame its reconstruction
    becomes _refFrame (:581-584).  B-frame bricks are coded against
    (_refFrame, predPointCloud2) with per-node direction selection
    (geometry_octree_encoder.cpp:1893-1920)."""
    from . import decoder as refdec
    from ..utils import morton as morton_mod

    out = []
    mask = (1 << sps.frame_ctr_bits) - 1
    ref1 = None    # _refFrame.cloud (slice-global STV, decode order)
    ref_ip = None  # biPredEncodeParams.predPointCloud2
    for fnum, is_b in bipred_coding_schedule(
            len(frames), random_access_period, period):
        if not is_b and ref_ip is not None:
            # start-of-compress reference swap (encoder.cpp:528-533)
            ref1 = ref_ip
        out.append(ref_hls.write_ref_tlv(ref_hls.T_SPS,
                                         ref_hls.write_sps(sps)))
        out.append(ref_hls.write_ref_tlv(ref_hls.T_GPS,
                                         ref_hls.write_gps(gps)))
        pos = np.asarray(frames[fnum], dtype=np.int64) - seq_origin
        if pos.size and pos.min() < 0:
            pos = np.maximum(pos, 0)
        if unique_points:
            codes_in = ((pos[:, 0] << 42) | (pos[:, 1] << 21)
                        | pos[:, 2])
            _, first = np.unique(codes_in, return_index=True)
            first.sort()
            pos = pos[first]
        if pos.shape[0] > max_points_per_slice:
            pos = pos[np.argsort(morton_mod.encode(pos))]
        n_slices = -(-pos.shape[0] // max_points_per_slice)
        per = -(-pos.shape[0] // max(n_slices, 1))
        frame_stv = []
        slice_id = 0
        code_inter = (fnum % random_access_period != 0
                      and ref1 is not None)
        for s in range(max(n_slices, 1)):
            part = pos[s * per:(s + 1) * per]
            if part.shape[0] == 0:
                continue
            origin = part.min(axis=0)
            local = part - origin
            whd = local.max(axis=0) + 1
            root = [max(_ceillog2(max(2, int(v))), 0) for v in whd]
            if not qtbt:
                root = [max(root)] * 3
            axes = np.asarray(qtbt_axis_list(root, qtbt),
                              dtype=np.int32)
            gbh = ref_hls.RefGbh(
                gps_id=0, slice_id=slice_id, slice_tag=0,
                frame_ctr_lsb=fnum & mask,
                geom_box_log2_scale=0,
                box_origin_stv=tuple(int(v) for v in origin),
                tree_lvl_coded_axis_list=list(axes),
                num_points=int(part.shape[0]),
                inter_prediction=code_inter,
                bi_prediction=bool(is_b and code_inter))
            if is_b and code_inter:
                aec = _encode_brick_native_bipred(
                    local, axes, gps, ref1, ref_ip,
                    origin.astype(np.int64),
                    bypass_no_update=bypass_no_update,
                    cabac_bypass=cabac_bypass)
            elif code_inter:
                aec = _encode_brick_native_inter(
                    local, axes, gps, gbh, ref1,
                    origin.astype(np.int64), 0,
                    np.zeros(3, dtype=np.int64),
                    bypass_no_update=bypass_no_update,
                    cabac_bypass=cabac_bypass)
            else:
                aec = _encode_brick_native(
                    local, axes, gps,
                    bypass_no_update=bypass_no_update,
                    cabac_bypass=cabac_bypass)
            brick = ref_hls.write_gbh(sps, gps, gbh, aec)
            out.append(ref_hls.write_ref_tlv(ref_hls.T_GEOM_BRICK,
                                             brick))
            # closed-loop reconstruction for the reference chain
            gbh_p = ref_hls.parse_gbh(sps, gps, brick)
            dec = refdec.decode_geometry_brick(
                sps, gps, gbh_p, brick, ref_cloud=ref1,
                ref2_cloud=ref_ip if (is_b and code_inter) else None)
            frame_stv.append(dec.astype(np.int64) + origin[None, :])
            slice_id += 1
        recon = np.concatenate(frame_stv, axis=0)
        if is_b:
            ref1 = recon        # encoder.cpp:581-584
        else:
            ref_ip = recon      # encoder.cpp:578-580
    return b"".join(out)


def encode_frames(frames, unique_points: bool = True,
                  planar: bool = True, qtbt: bool = True,
                  max_points_per_slice: int = 1_100_000,
                  trisoup_node_size_log2: int = 0,
                  colors=None, reflectances=None,
                  attr_qp: int = 34, attr_qp_chroma_offset: int = 0,
                  attr_bitdepth: int = 8,
                  integer_haar: bool = False,
                  attr_cicp_matrix: int = 1,
                  bypass_no_update: bool = True,
                  attr_aps=None,
                  idcm: int = 0,
                  angular: bool = False,
                  angular_head=(0, 0, 0),
                  lasers_theta=None,
                  lasers_z=None,
                  lasers_num_phi=None,
                  predgeom: bool = False,
                  cabac_bypass: bool = False,
                  inter: bool = False,
                  global_motion: bool = True,
                  bi_prediction: bool = False,
                  bi_prediction_period: int = 2,
                  random_access_period: int = 8,
                  motion_block_size=(0, 0, 4096),
                  motion_window_size: int = 512,
                  gm_th_dist: int = 1000,
                  motion_params=None,
                  z_compensation: bool = False,
                  attr_slice_rdo: bool = False,
                  attr_inter_translation_threshold: float = 1000.0,
                  adjacent_child: bool = True,
                  bitwise_occupancy: bool = True,
                  neighbour_avail_boundary_log2: int = 8,
                  secondary_residual_disabled: bool = False,
                  azimuth_quantization: bool = True,
                  gps_overrides=None, aps_overrides=None,
                  ) -> bytes:
    """Encode a sequence of XYZ integer clouds into one reference-
    syntax TLV stream (SPS + GPS once, then per-slice geometry
    bricks).  Clouds above the slice level limit (reference
    encoder.cpp:1023, 1.1M points) are split along the Morton order
    with per-slice origins.

    With ``inter`` every non-random-access frame is coded against the
    previous frame's reconstruction, with the reference's internal
    LMS global-motion search and the cuboid LPU partition (lpuType 1,
    the reference's working configuration) when ``global_motion``.

    ``colors``/``reflectances`` are optional per-frame lists of values
    already in the internal coding representation (GBR order, or
    YCbCr when the caller converted): each geometry brick is followed
    by a RAHT attribute brick.  When geometry is lossy (trisoup), the
    source attributes are recoloured onto the reconstruction first
    (reference transferAttributes, pointset_processing.cpp:267+)."""
    from ..utils import morton as morton_mod

    attr_frames = colors if colors is not None else reflectances
    have_attrs = attr_frames is not None

    # one bit indicates frame boundaries (encoder.cpp:731-733); under
    # bi-prediction enough bits to disambiguate the out-of-order GOF
    # coding (encoder.cpp:734-741)
    frame_ctr_bits = 1
    if bi_prediction:
        bits = 1
        while bi_prediction_period >> bits:
            bits += 1
        frame_ctr_bits = bits + 1
    # sequence bounding box: auto-derived from the first frame and
    # recorded in the SPS; slice origins are coded relative to it
    # (encoder.cpp:118-156, autoSeqBbox, global scale 1)
    seq_origin = (np.asarray(frames[0], dtype=np.int64).min(axis=0)
                  if len(frames) and np.asarray(frames[0]).size
                  else np.zeros(3, dtype=np.int64))
    if cabac_bypass:
        # sanitizer TMC3.cpp:2021-2023
        bypass_no_update = False
    sps = ref_hls.RefSps(
        main_profile_compat=0, level=0, sps_id=0,
        frame_ctr_bits=frame_ctr_bits, slice_tag_bits=0,
        geometry_axis_order=1,
        bbox_origin=tuple(int(v) for v in seq_origin))
    sps.cabac_bypass_stream_enabled = cabac_bypass
    sps.bypass_bin_coding_without_prob_update = bypass_no_update
    aps = None
    if have_attrs:
        dims = 3 if colors is not None else 1
        sps.num_attrs = 1
        sps.attr_dims = [dims]
        sps.attr_bitdepths = [attr_bitdepth]
        # KnownAttributeLabel (hls.h): 0 = colour, 1 = reflectance
        sps.attr_labels = [0 if colors is not None else 1]
        # colours always carry a cicp parameter block
        # (TMC3.cpp:1834-1837); reflectance never does
        sps.attr_cicp_matrix = [attr_cicp_matrix
                                if colors is not None else None]
        # tmc3 APS defaults (TMC3.cpp:1290-1319; search range
        # sanitised to the level limit, encoder.cpp:808)
        aps = attr_aps if attr_aps is not None else derive_default_aps(
            ref_hls.ATTR_RAHT, attr_qp=attr_qp,
            attr_qp_chroma_offset=attr_qp_chroma_offset,
            integer_haar=integer_haar)
    if not bitwise_occupancy:
        # bytewise occupancy: planar sanitised off (TMC3.cpp:1727-31)
        planar = False
    gps = ref_hls.RefGps(
        gps_id=0, sps_id=0, geom_box_log2_scale_present=True,
        qtbt_enabled=qtbt, unique_points=unique_points,
        neighbour_avail_boundary_log2_minus1=(
            neighbour_avail_boundary_log2 - 1),
        adjacent_child_contextualization=adjacent_child,
        bitwise_occupancy=bitwise_occupancy,
        planar_enabled=planar,
        planar_threshold0=77, planar_threshold1=99,
        planar_threshold2=113,
        depth_planar_eligibility=planar,
        planar_dynamic_obuf_eligibility=planar,
        multiple_planar=planar,
        trisoup_enabled=bool(trisoup_node_size_log2),
        non_cubic_node_start_edge=bool(trisoup_node_size_log2),
        non_cubic_node_end_edge=bool(trisoup_node_size_log2))
    if angular and idcm == 1:
        # tmc3 sanitizer: rate-limited IDCM silently disabled with
        # angular unless planarModeIdcmUse > 0
        idcm = 0
    gps.inferred_direct_coding_mode = idcm
    gps.joint_2pt_idcm = bool(idcm)
    gps.idcm_rate_minus1 = 31 if idcm else 0
    if angular:
        # laser tables at coding scale 1 (TMC3.cpp:1925-1945); head
        # relative to the sequence origin (encoder.cpp:168-169)
        gps.angular_enabled = True
        gps.angular_origin = tuple(
            int(v) - int(o) for v, o in zip(angular_head, seq_origin))
        gps.angular_theta = [int(round(v * (1 << 18)))
                             for v in lasers_theta]
        gps.angular_z = [int(round(v * 8)) for v in lasers_z]
        gps.angular_num_phi = [int(v) for v in lasers_num_phi]
        gps.octree_angular_extension = True
        gps.planar_disabled_idcm_angular = bool(planar and idcm)
        gps.planar_dynamic_obuf_eligibility = False
    if predgeom:
        # predictive geometry at tmc3 CLI defaults (encode_stream's
        # predgeom block documents the derivations)
        if not angular:
            raise NotImplementedError(
                "refSyntax predgeom requires the angular tool set")
        gps.predgeom_enabled = True
        gps.planar_enabled = False
        gps.inferred_direct_coding_mode = 0
        gps.joint_2pt_idcm = False
        gps.azimuth_scale_log2_minus11 = 5
        gps.azimuth_speed_minus1 = 362
        gps.radius_inv_scale_log2 = 0
        gps.residual2_disabled = False
        gps.azimuth_scaling_enabled = True
        gps.predgeom_max_pred_index = 3
        gps.predgeom_radius_threshold = 2048 >> gps.radius_inv_scale_log2
        gps.resr_qphi_threshold_present = False
        gps.residual2_disabled = bool(secondary_residual_disabled)
        gps.azimuth_scaling_enabled = bool(azimuth_quantization)
    if bi_prediction and not inter:
        # sanitizer TMC3.cpp:1766-1768
        bi_prediction = False
    if inter:
        if trisoup_node_size_log2 or predgeom:
            raise NotImplementedError(
                "inter emission outside the octree tool set")
        if bi_prediction:
            if angular or global_motion:
                raise NotImplementedError(
                    "bi-prediction emission: plain octree tool set "
                    "only (no GM/angular; biPredictionEligibility is "
                    "unconditional without GM, encoder.cpp:917-918)")
            if have_attrs:
                # RAHT forces biPrediction off (TMC3.cpp:1910-1912);
                # pred/lift B-frame attr references are out of scope
                raise NotImplementedError(
                    "bi-prediction emission is geometry-only")
            gps.bi_prediction = 1
        if angular and global_motion and motion_params is None:
            raise NotImplementedError(
                "angular inter emission needs an external motion "
                "file (the reference's internal-LMS + angular path "
                "needs content-specific gmThreshold bounds)")
        if (have_attrs and aps is not None
                and aps.attr_inter_prediction
                and aps.attr_encoding != ref_hls.ATTR_RAHT
                and colors is not None):
            raise NotImplementedError(
                "pred/lift attribute inter emission is scalar-only "
                "(the reference's inter candidates exist only for "
                "reflectance, AttributeEncoder.cpp:695-702)")
        sps.inter_frame_prediction_enabled = True
        gps.inter_prediction = True
        gps.global_motion = global_motion
        # sanitiser: multiple planar is disabled under inter
        # (TMC3.cpp:1763-1764)
        gps.multiple_planar = False
        if angular:
            # interIDCMPredEnabled default (TMC3.cpp:1038-1040) and
            # the one-point-alone derivation from the first frame's
            # point count vs the total phi slots (encoder.cpp:171-186)
            gps.inter_idcm = True
            max_per_turn = sum(gps.angular_num_phi) or 1
            gps.one_point_alone_laser_beam = (
                len(frames[0]) / float(max_per_turn) < 2)
            gps.z_compensation = bool(z_compensation)
    # user overrides of syntax fields the engines honor (CLI option
    # surface: runtime/cli.py _REF_APS_OPTIONS/_REF_GPS_OPTIONS)
    for f, v in (gps_overrides or {}).items():
        setattr(gps, f, v)
    if gps_overrides and "radius_inv_scale_log2" in gps_overrides \
            and "predgeom_radius_threshold" not in gps_overrides \
            and gps.predgeom_enabled:
        gps.predgeom_radius_threshold = 2048 >> gps.radius_inv_scale_log2
    for f, v in (aps_overrides or {}).items():
        if aps is not None:
            setattr(aps, f, v)
    if inter and bi_prediction:
        return _encode_bipred_stream(
            frames, sps, gps, seq_origin, unique_points, qtbt,
            max_points_per_slice, random_access_period,
            bi_prediction_period, bypass_no_update, cabac_bypass)
    ts_log2 = trisoup_node_size_log2
    out = []
    # inter frame chaining: previous frame's reconstruction in
    # slice-global STV (the encoder-side _refFrameSeq store)
    ref_cloud: Optional[np.ndarray] = None
    # attribute inter reference chain: previous frame's attr coding
    # positions + closed-loop reconstruction (encoder.cpp:1468-1484)
    attr_ref_chain = None
    for ctr, cloud in enumerate(frames):
        next_attr_chain = []
        # slice ids restart at each frame (encoder.cpp _sliceId
        # reset in compress())
        slice_id = 0
        # the reference writes all parameter sets before EVERY frame
        # (encoder.cpp:332-337)
        out.append(ref_hls.write_ref_tlv(ref_hls.T_SPS,
                                         ref_hls.write_sps(sps)))
        out.append(ref_hls.write_ref_tlv(ref_hls.T_GPS,
                                         ref_hls.write_gps(gps)))
        if aps is not None:
            out.append(ref_hls.write_ref_tlv(ref_hls.T_APS,
                                             ref_hls.write_aps(aps)))
        frame_stv = []        # this frame's reconstruction (global)
        pos = np.asarray(cloud, dtype=np.int64) - seq_origin
        if pos.size and pos.min() < 0:
            # later frames may undershoot the first frame's bbox; the
            # reference CLAMPS to the coding box (quantizePositionsUniq
            # clampBox [0, INT32_MAX), encoder.cpp:1558-1561)
            pos = np.maximum(pos, 0)
        av = (np.asarray(attr_frames[ctr]) if have_attrs else None)
        if av is not None and av.ndim == 1:
            av = av[:, None]
        if unique_points:
            # first-occurrence dedup like the reference
            # (reducePointSet): input order is normative under
            # angular IDCM (unstable counting sort)
            codes_in = ((pos[:, 0] << 42) | (pos[:, 1] << 21)
                        | pos[:, 2])
            _, first = np.unique(codes_in, return_index=True)
            first.sort()
            pos = pos[first]
            if av is not None:
                av = av[first]
        if pos.shape[0] > max_points_per_slice:
            # multi-slice: Morton order drives the slice split
            order = np.argsort(morton_mod.encode(pos))
            pos = pos[order]
            if av is not None:
                av = av[order]
        n_slices = -(-pos.shape[0] // max_points_per_slice)
        per = -(-pos.shape[0] // max(n_slices, 1))
        for s in range(max(n_slices, 1)):
            part = pos[s * per:(s + 1) * per]
            apart = (av[s * per:(s + 1) * per]
                     if av is not None else None)
            if part.shape[0] == 0:
                continue
            origin = part.min(axis=0)
            local = part - origin

            # pred/lift attribute inter gating: the frame must be
            # "non-moving" under the coded global motion
            # (checkMovingState, encoder.cpp:1469-1496); filled in by
            # the inter geometry paths below once the GM is known
            frame_state = {"moving_ok": False}

            def _emit_attr(dec_pos, _origin=origin, _local=local,
                           _apart=apart, _slice_id_ref=None):
                # attributes follow their geometry slice, coded at the
                # DECODED positions in decode order (decoder.cpp:921-2)
                # on the slice-origin-ADDED positions (encoder.cpp:1210)
                attr_pos = dec_pos.astype(np.int64) + _origin
                if ts_log2:
                    from ..models.pointcloud import PointCloud
                    from ..ops import recolour as rc
                    dt = (np.uint8 if attr_bitdepth <= 8
                          else np.uint16)
                    src_cloud = PointCloud(
                        positions=_local.astype(np.int64),
                        colors=(_apart.astype(dt)
                                if _apart.shape[1] == 3 else None),
                        reflectances=(_apart[:, 0].astype(dt)
                                      if _apart.shape[1] == 1
                                      else None))
                    tgt = rc.recolour(src_cloud,
                                      dec_pos.astype(np.int64))
                    aslice = (tgt.colors if _apart.shape[1] == 3
                              else tgt.reflectances[:, None])
                    aslice = np.asarray(aslice, dtype=np.int32)
                else:
                    k_dec = ((dec_pos[:, 0].astype(np.int64) << 42)
                             | (dec_pos[:, 1].astype(np.int64) << 21)
                             | dec_pos[:, 2].astype(np.int64))
                    k_src = ((_local[:, 0] << 42)
                             | (_local[:, 1] << 21) | _local[:, 2])
                    os_ = np.argsort(k_src)
                    src_row = os_[np.searchsorted(k_src[os_], k_dec)]
                    aslice = _apart[src_row].astype(np.int32)
                if aps.attr_encoding == ref_hls.ATTR_RAHT:
                    # abh.enableAttrInterPred for RAHT = the frame is
                    # coded inter (encoder.cpp:1096-1099)
                    frame_inter = (inter and aps.attr_inter_prediction
                                   and ctr % random_access_period != 0
                                   and attr_ref_chain is not None)
                    # per-slice dist2 estimate rides the ABH under
                    # inter even for RAHT (encoder.cpp:1199-1206)
                    d2d = 0
                    if frame_inter:
                        pos_ = dec_pos.astype(np.int64)
                        n_ = pos_.shape[0]
                        if n_ >= 2:
                            dists = []
                            for idx in range(0, n_, 100):
                                k0 = max(0, idx - 128)
                                k1 = min(n_ - 1, idx + 128)
                                w_ = pos_[k0:k1 + 1] - pos_[idx]
                                dd = (w_ * w_).sum(axis=1)
                                dd[idx - k0] = np.iinfo(np.int64).max
                                dists.append(int(dd.min()))
                            dists = np.asarray(dists, dtype=np.int64)
                            pq = int(np.floor(len(dists) * 0.85))
                            d2v = int(np.partition(dists, pq)[pq])
                            shift = 0
                            while (3 << (shift << 1)) < d2v and shift < 20:
                                shift += 1
                            d2d = shift - aps.dist2
                    (attr_aec, arec, amodes,
                     ataps) = encode_attr_brick_native(
                        sps, aps, attr_pos, aslice,
                        attr_ref=(attr_ref_chain if frame_inter
                                  else None))
                    abrick = ref_hls.write_abh(
                        aps, 0, slice_id, attr_aec,
                        dist2_delta=d2d,
                        enable_inter=frame_inter,
                        raht_filter_taps=ataps,
                        raht_layer_modes=amodes)
                    if aps.attr_inter_prediction:
                        next_attr_chain.append((attr_pos, arec))
                else:
                    dims_ = aslice.shape[1]
                    # abh.enableAttrInterPred for pred/lift =
                    # movingState (encoder.cpp:1096-1099)
                    frame_inter = (inter and aps.attr_inter_prediction
                                   and ctr % random_access_period != 0
                                   and attr_ref_chain is not None
                                   and frame_state["moving_ok"]
                                   and dims_ == 1)
                    if frame_inter:
                        # inter candidates + optional two-pass slice
                        # RDO (AttributeEncoder.cpp:498-580)
                        (attr_aec, d2d, en_inter,
                         arec) = encode_attr_brick_predlift_inter(
                            sps, aps, attr_pos, aslice,
                            attr_ref_chain, attr_slice_rdo)
                        lcp = icp = None
                        abrick = ref_hls.write_abh(
                            aps, 0, slice_id, attr_aec, dims=dims_,
                            dist2_delta=d2d, enable_inter=en_inter)
                    else:
                        (attr_aec, lcp, icp, arec,
                         d2d) = encode_attr_brick_predlift(
                            sps, aps, attr_pos, aslice)
                        abrick = ref_hls.write_abh(
                            aps, 0, slice_id, attr_aec, dims=dims_,
                            lcp_coeffs=(lcp
                                        if aps.last_component_prediction
                                        and dims_ == 3 else None),
                            icp_coeffs=(icp
                                        if aps.inter_component_prediction
                                        and dims_ != 1 else None),
                            dist2_delta=d2d)
                    if aps.attr_inter_prediction:
                        next_attr_chain.append((attr_pos, arec))
                out.append(ref_hls.write_ref_tlv(ref_hls.T_ATTR_BRICK,
                                                 abrick))

            whd = local.max(axis=0) + 1
            root = [max(_ceillog2(max(2, int(v))), ts_log2)
                    for v in whd]
            if not qtbt:
                root = [max(root)] * 3
            if ts_log2:
                # trisoup: qtbt-first schedule truncated at the
                # trisoup node size (geometry_octree.cpp:114-118,
                # geometry_octree_encoder.cpp:1984-1994)
                axes = np.asarray(qtbt_axis_list(
                    root, qtbt,
                    max_num_qtbt_before_ot=max(root) - min(root),
                    min_qtbt_size_log2=0, stop_log2=ts_log2),
                    dtype=np.int32)
                aec, tfields, recon = _encode_trisoup_brick_native(
                    local, axes, gps, ts_log2,
                    slice_max_points=max_points_per_slice,
                    bypass_no_update=bypass_no_update)
                extra = dict(num_points=int(recon.shape[0]), **tfields)
            elif predgeom:
                axes = np.zeros(0, dtype=np.int32)
                root_pg = [_ceillog2(max(2, int(v))) for v in whd]
                origin_stv = (
                    np.asarray(ref_hls.from_xyz(
                        1, list(gps.angular_origin)), dtype=np.int64)
                    - origin)
                aec, residbits, minr = _encode_predgeom_brick_native(
                    local, gps, origin_stv, root_pg,
                    bypass_no_update=bypass_no_update,
                    cabac_bypass=cabac_bypass)
                extra = dict(num_points=int(part.shape[0]),
                             pgeom_resid_abs_log2_bits=residbits,
                             pgeom_min_radius=minr)
            elif angular:
                axes = np.asarray(qtbt_axis_list(
                    root, qtbt, angular_tweak=True, ang_max_v=8,
                    ang_max_diff_z=1), dtype=np.int32)
                code_inter = (inter
                              and (ctr % random_access_period != 0)
                              and ref_cloud is not None)
                if code_inter:
                    gbh = ref_hls.RefGbh(
                        gps_id=0, slice_id=slice_id, slice_tag=0,
                        frame_ctr_lsb=(ctr
                                       & ((1 << frame_ctr_bits) - 1)),
                        geom_box_log2_scale=0,
                        box_origin_stv=tuple(int(v) for v in origin),
                        tree_lvl_coded_axis_list=list(axes),
                        num_points=int(part.shape[0]),
                        inter_prediction=True)
                    # external GM (kExternalGMSrc): per-frame file row,
                    # minimum position = seq bbox origin
                    # (encoder applyGlobalMotion :1779-1796)
                    min_pos = np.zeros(3, dtype=np.int64)
                    if global_motion:
                        gbh.lpu_type = 1
                        gbh.motion_block_size = tuple(
                            int(v) for v in motion_block_size)
                        row = motion_params[
                            min(ctr - 1, len(motion_params) - 1)]
                        gbh.gm_matrix, gbh.gm_trans, gbh.gm_thresh = \
                            row
                        gbh.min_zero_origin = False
                        min_pos = np.asarray(ref_hls.from_xyz(
                            sps.geometry_axis_order,
                            list(sps.bbox_origin)), dtype=np.int64)
                    frame_state["moving_ok"] = _check_moving_state(
                        getattr(gbh, "gm_matrix", [65536, 0, 0, 0,
                                                   65536, 0, 0, 0,
                                                   65536]),
                        getattr(gbh, "gm_trans", (0, 0, 0)),
                        attr_inter_translation_threshold)
                    org_ang = (np.asarray(ref_hls.from_xyz(
                        1, list(gps.angular_origin)), dtype=np.int64)
                        - origin)
                    aec = _encode_brick_native_inter(
                        local, axes, gps, gbh, ref_cloud,
                        origin.astype(np.int64), motion_window_size,
                        min_pos,
                        bypass_no_update=bypass_no_update,
                        cabac_bypass=cabac_bypass,
                        ang_origin=org_ang)
                    brick = ref_hls.write_gbh(sps, gps, gbh, aec)
                    out.append(ref_hls.write_ref_tlv(
                        ref_hls.T_GEOM_BRICK, brick))
                    from . import decoder as refdec
                    gbh_p = ref_hls.parse_gbh(sps, gps, brick)
                    dec = refdec.decode_geometry_brick(
                        sps, gps, gbh_p, brick, ref_cloud=ref_cloud)
                    frame_stv.append(dec.astype(np.int64)
                                     + origin[None, :])
                    if apart is not None:
                        _emit_attr(dec)
                    slice_id += 1
                    continue
                aec = _encode_brick_native_ang(
                    local, axes, gps,
                    bypass_no_update=bypass_no_update,
                    box_origin_stv=tuple(int(v) for v in origin),
                    cabac_bypass=cabac_bypass)
                extra = dict(num_points=int(part.shape[0]))
            else:
                axes = np.asarray(qtbt_axis_list(root, qtbt),
                                  dtype=np.int32)
                code_inter = (inter
                              and (ctr % random_access_period != 0)
                              and ref_cloud is not None)
                if code_inter:
                    gbh = ref_hls.RefGbh(
                        gps_id=0, slice_id=slice_id, slice_tag=0,
                        frame_ctr_lsb=(ctr
                                       & ((1 << frame_ctr_bits) - 1)),
                        geom_box_log2_scale=0,
                        box_origin_stv=tuple(int(v) for v in origin),
                        tree_lvl_coded_axis_list=list(axes),
                        num_points=int(part.shape[0]),
                        inter_prediction=True)
                    min_pos = np.zeros(3, dtype=np.int64)
                    if global_motion:
                        gbh.lpu_type = 1
                        gbh.motion_block_size = tuple(
                            int(v) for v in motion_block_size)
                        if motion_params is not None:
                            # external GM file (kExternalGMSrc):
                            # min position = seq bbox origin
                            row = motion_params[
                                min(ctr - 1, len(motion_params) - 1)]
                            (gbh.gm_matrix, gbh.gm_trans,
                             gbh.gm_thresh) = row
                            gbh.min_zero_origin = False
                            min_pos = np.asarray(ref_hls.from_xyz(
                                sps.geometry_axis_order,
                                list(sps.bbox_origin)),
                                dtype=np.int64)
                        else:
                            # internal LMS: min position pinned to
                            # zero (applyGlobalMotion kInternalLMS)
                            gbh.min_zero_origin = True
                            gbh.gm_matrix, gbh.gm_trans = \
                                search_global_motion(
                                    part, ref_cloud, max(root),
                                    bsize=gbh.motion_block_size[2],
                                    th_dist=gm_th_dist)
                    frame_state["moving_ok"] = _check_moving_state(
                        getattr(gbh, "gm_matrix", [65536, 0, 0, 0,
                                                   65536, 0, 0, 0,
                                                   65536]),
                        getattr(gbh, "gm_trans", (0, 0, 0)),
                        attr_inter_translation_threshold)
                    aec = _encode_brick_native_inter(
                        local, axes, gps, gbh, ref_cloud,
                        origin.astype(np.int64), motion_window_size,
                        min_pos,
                        bypass_no_update=bypass_no_update,
                        cabac_bypass=cabac_bypass)
                    brick = ref_hls.write_gbh(sps, gps, gbh, aec)
                    out.append(ref_hls.write_ref_tlv(
                        ref_hls.T_GEOM_BRICK, brick))
                    from . import decoder as refdec
                    gbh_p = ref_hls.parse_gbh(sps, gps, brick)
                    dec = refdec.decode_geometry_brick(
                        sps, gps, gbh_p, brick, ref_cloud=ref_cloud)
                    frame_stv.append(dec.astype(np.int64)
                                     + origin[None, :])
                    if apart is not None:
                        _emit_attr(dec)
                    slice_id += 1
                    continue
                aec = _encode_brick_native(
                    local, axes, gps, bypass_no_update=bypass_no_update,
                    cabac_bypass=cabac_bypass)
                extra = dict(num_points=int(part.shape[0]))
            gbh = ref_hls.RefGbh(
                gps_id=0, slice_id=slice_id, slice_tag=0,
                frame_ctr_lsb=ctr & ((1 << frame_ctr_bits) - 1),
                geom_box_log2_scale=0,
                box_origin_stv=tuple(int(v) for v in origin),
                tree_lvl_coded_axis_list=list(axes), **extra)
            brick = ref_hls.write_gbh(sps, gps, gbh, aec)
            out.append(ref_hls.write_ref_tlv(ref_hls.T_GEOM_BRICK,
                                             brick))
            if inter:
                from . import decoder as refdec
                gbh_p = ref_hls.parse_gbh(sps, gps, brick)
                dec = refdec.decode_geometry_brick(sps, gps, gbh_p,
                                                   brick)
                frame_stv.append(dec.astype(np.int64)
                                 + origin[None, :])
            if apart is not None:
                from . import decoder as refdec
                gbh_p = ref_hls.parse_gbh(sps, gps, brick)
                dec_pos = refdec.decode_geometry_brick(
                    sps, gps, gbh_p, brick)
                _emit_attr(dec_pos)
            slice_id += 1
        if inter and frame_stv:
            ref_cloud = np.concatenate(frame_stv, axis=0)
        if next_attr_chain:
            attr_ref_chain = (
                np.concatenate([p for p, _ in next_attr_chain], axis=0),
                np.concatenate([a for _, a in next_attr_chain], axis=0))
    return b"".join(out)


def derive_default_aps(attr_encoding: int, attr_qp: int = 34,
                       attr_qp_chroma_offset: int = 0,
                       integer_haar: bool = False,
                       num_detail_levels_minus1: int = 1,
                       lod_decimation_type: int = 0,
                       lod_sampling_periods=None,
                       dist2: int = 0,
                       inter_component_prediction: bool = False,
                       last_component_prediction: bool = False,
                       attr_inter_prediction: bool = False,
                       raht_send_inter_filters: bool = False
                       ) -> "ref_hls.RefAps":
    """tmc3-default APS for RAHT/PRED/LIFT (option defaults
    TMC3.cpp:1290-1400; sanitizer encoder.cpp:765-830, TMC3.cpp:1878)."""
    if attr_encoding == ref_hls.ATTR_RAHT:
        a = ref_hls.RefAps(
            aps_id=0, sps_id=0, attr_encoding=ref_hls.ATTR_RAHT,
            init_qp_minus4=attr_qp - 4,
            chroma_qp_offset=attr_qp_chroma_offset,
            raht_prediction_enabled=True,
            raht_prediction_threshold0=2, raht_prediction_threshold1=6,
            integer_haar=integer_haar, raht_extension=True,
            raht_subnode_prediction=True,
            raht_prediction_weights=[9, 3, 1, 5, 2],
            raht_prediction_search_range=1100000)
        if attr_inter_prediction:
            # tmc3 inter-attribute defaults (TMC3.cpp:1453-1476)
            a.attr_inter_prediction = True
            a.raht_inter_depth_minus1 = 15
            a.raht_send_inter_filters = raht_send_inter_filters
            a.raht_inter_skip_layers = 3
            a.raht_enable_code_layer = True
        return a
    pred = attr_encoding == ref_hls.ATTR_PRED
    ndl = num_detail_levels_minus1
    max_lvls = ndl + 1
    # encoder.cpp:779-784: skip layers -1 -> all, clamped to lvls+1
    skip = max_lvls + 1
    intra_range = 0 if skip > max_lvls else 1100000
    inter_range = 0 if max_lvls == 1 else 1100000
    d2p = (ndl > 0 and lod_decimation_type != 1)
    if lod_decimation_type == 2:
        d2p = False
    periods = None
    if ndl and lod_decimation_type != 0:
        base = list(lod_sampling_periods or [2])
        while len(base) < ndl:
            base.append(base[-1])
        periods = base[:ndl]
    return ref_hls.RefAps(
        aps_id=0, sps_id=0, attr_encoding=attr_encoding,
        init_qp_minus4=attr_qp - 4,
        chroma_qp_offset=attr_qp_chroma_offset,
        num_pred_nearest_neighbours_minus1=2,
        inter_lod_search_range=inter_range,
        lod_neigh_bias=(1, 1, 1),
        last_component_prediction=(last_component_prediction
                                   and not pred),
        num_detail_levels_minus1=ndl,
        canonical_point_order=False,
        lod_decimation_type=lod_decimation_type if ndl else 0,
        lod_sampling_periods=periods,
        dist2=dist2,
        slice_dist2_deltas_present=d2p,
        max_num_direct_predictors=3 if pred else 0,
        adaptive_prediction_threshold=64 if pred else 0,
        direct_avg_predictor_disabled=False,
        intra_lod_prediction_skip_layers=skip,
        intra_lod_search_range=intra_range if pred else 0,
        inter_component_prediction=(inter_component_prediction
                                    and pred),
        pred_weight_blending=False,
        quant_neigh_weight=[16, 8, 4] if pred else None,
        max_points_per_sort_log2_plus1=0,
        prediction_with_distribution=True)


def _check_moving_state(gm_matrix, gm_trans, translation_threshold,
                        frame_distance: int = 1) -> bool:
    """checkMovingState (encoder.cpp:1475-1493): pred/lift attribute
    inter prediction is enabled only when the coded global motion is
    below small rotation/translation thresholds."""
    import math
    scale = 65536.0
    thr1 = 0.1 / frame_distance
    thr1_tan = math.tan(math.pi * thr1 / 180)
    thr1_sin = math.sin(math.pi * thr1 / 180)
    mat = list(gm_matrix)
    rx = abs((mat[5] / scale) / (1.0 + mat[8] / scale))
    ry = abs(mat[2] / scale)
    rz = abs((mat[1] / scale) / (1.0 + mat[0] / scale))
    sx, sy, sz = (abs(v) for v in gm_trans)
    thr2 = translation_threshold
    return (rx < thr1_tan and ry < thr1_sin and rz < thr1_tan
            and sx < thr2 and sy < thr2 and sz < thr2)


def _estimate_dist2_delta(positions_stv: np.ndarray, aps) -> int:
    """Per-slice dist2 refinement (estimateDist2,
    AttributeEncoder.cpp:1685-1720; call site encoder.cpp:1204 with
    samplingPeriod 100, searchRange 128, percentile 0.85)."""
    pos = np.asarray(positions_stv, dtype=np.int64)
    n_ = pos.shape[0]
    if n_ < 2:
        return 0
    dists = []
    for idx in range(0, n_, 100):
        k0 = max(0, idx - 128)
        k1 = min(n_ - 1, idx + 128)
        w = pos[k0:k1 + 1] - pos[idx]
        d2 = (w * w).sum(axis=1)
        d2[idx - k0] = np.iinfo(np.int64).max
        dists.append(int(d2.min()))
    dists = np.asarray(dists, dtype=np.int64)
    p = int(np.floor(len(dists) * 0.85))
    d2v = int(np.partition(dists, p)[p])
    shift = 0
    while (3 << (shift << 1)) < d2v and shift < 20:
        shift += 1
    return shift - aps.dist2


def encode_attr_brick_predlift_inter(sps, aps, positions_stv, attrs,
                                     attr_ref, slice_rdo: bool):
    """Predicting/lifting inter-frame attribute encode (reflectance),
    byte-identical to the reference: the previous frame's attribute
    cloud joins the LoD candidate pool after bbox filtering
    (decoder.cpp:926-947 mirrored encoder-side), and with
    ``slice_rdo`` the two-pass inter/intra slice RDO picks the cheaper
    coding (AttributeEncoder.cpp:498-580, attrInterIntraSliceRDO).
    Returns (payload bytes, dist2_delta, enable_inter, recon)."""
    from .decoder import _load, _predlift_params
    lib = _load()
    c = ctypes
    if not hasattr(lib.tmc13ref_encode_predlift_inter, "_configured"):
        lib.tmc13ref_encode_predlift_inter.argtypes = [
            c.POINTER(c.c_int32), c.c_int, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int,
            c.c_int, c.c_int,
            c.POINTER(c.c_uint8), c.c_int, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32)]
        lib.tmc13ref_encode_predlift_inter.restype = c.c_int
        lib.tmc13ref_encode_predlift_inter._configured = True

    def p32(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    abh_stub = ref_hls.RefAbh()
    # dist2 delta rides the ABH whenever inter prediction is active
    # (encoder.cpp:1201)
    abh_stub.attr_dist2_delta = _estimate_dist2_delta(positions_stv, aps)
    abh_stub.enable_attr_inter_pred = True
    layers = ref_hls.derive_layer_qps(aps, abh_stub)
    qp_arr = np.asarray(layers, dtype=np.int32).reshape(-1)
    params = _predlift_params(sps, aps, abh_stub, len(layers))

    nper = max(aps.num_detail_levels_minus1, 1)
    periods = np.zeros(nper, dtype=np.int32)
    if aps.lod_sampling_periods:
        periods[:len(aps.lod_sampling_periods)] = aps.lod_sampling_periods

    pos32 = np.ascontiguousarray(positions_stv, dtype=np.int32)
    n = int(pos32.shape[0])
    av = np.ascontiguousarray(attrs, dtype=np.int32)
    if av.ndim != 2 or av.shape[1] != 1:
        raise NotImplementedError("inter predlift is scalar-only")

    # reference cloud: bbox-filtered, order-preserving (same filter as
    # the decoder so both sides see the identical candidate pool)
    ref_pos, ref_attr = attr_ref
    ref_pos = np.asarray(ref_pos, dtype=np.int64)
    ref_attr = np.asarray(ref_attr, dtype=np.int32).reshape(
        ref_pos.shape[0], -1)
    lo = pos32.min(axis=0).astype(np.int64)
    hi = pos32.max(axis=0).astype(np.int64)
    keep = np.all((ref_pos >= lo[None, :]) & (ref_pos <= hi[None, :]),
                  axis=1)
    rpos = np.ascontiguousarray(ref_pos[keep], dtype=np.int32)
    rattr = np.ascontiguousarray(ref_attr[keep].reshape(-1),
                                 dtype=np.int32)
    nref = int(rpos.shape[0])
    if nref == 0:
        # empty candidate pool: the reference falls back to intra
        payload, lcp, icp, recon, d2d = encode_attr_brick_predlift(
            sps, aps, positions_stv, attrs)
        return payload, d2d, False, recon

    recon = np.empty_like(av)
    cap = n * 16 + (1 << 16)
    buf = np.empty(cap, dtype=np.uint8)
    enable = np.zeros(1, dtype=np.int32)
    nb = lib.tmc13ref_encode_predlift_inter(
        p32(pos32), n, p32(params), p32(periods), p32(qp_arr),
        p32(av.reshape(-1)),
        p32(rpos), p32(rattr), nref,
        int(aps.attr_inter_pred_search_range), 1 if slice_rdo else 0,
        buf.ctypes.data_as(c.POINTER(c.c_uint8)), cap,
        p32(recon.reshape(-1)), p32(enable))
    if nb < 0:
        raise RuntimeError(f"refpredlift inter encode rc={nb}")
    return (buf[:nb].tobytes(), abh_stub.attr_dist2_delta,
            bool(enable[0]), recon)


def encode_attr_brick_predlift(sps, aps, positions_stv: np.ndarray,
                               attrs: np.ndarray):
    """Predicting/lifting-encode attributes aligned to decode-order
    positions, byte-identical to the reference encoder
    (AttributeEncoder.cpp:750-1650).  Returns (AEC payload bytes,
    lcp_coeffs, icp_coeffs, reconstructed attrs)."""
    from .decoder import _load, _predlift_params
    lib = _load()
    c = ctypes
    if not hasattr(lib.tmc13ref_encode_predlift, "_configured"):
        lib.tmc13ref_encode_predlift.argtypes = [
            c.POINTER(c.c_int32), c.c_int, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_uint8), c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int32)]
        lib.tmc13ref_encode_predlift.restype = c.c_int
        lib.tmc13ref_encode_predlift._configured = True

    def p32(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    abh_stub = ref_hls.RefAbh()
    if aps.slice_dist2_deltas_present:
        abh_stub.attr_dist2_delta = _estimate_dist2_delta(
            positions_stv, aps)
    layers = ref_hls.derive_layer_qps(aps, abh_stub)
    qp_arr = np.asarray(layers, dtype=np.int32).reshape(-1)
    from .decoder import _predlift_params as _pp
    params = _pp(sps, aps, abh_stub, len(layers))

    nper = max(aps.num_detail_levels_minus1, 1)
    periods = np.zeros(nper, dtype=np.int32)
    if aps.lod_sampling_periods:
        periods[:len(aps.lod_sampling_periods)] = aps.lod_sampling_periods

    pos32 = np.ascontiguousarray(positions_stv, dtype=np.int32)
    n = int(pos32.shape[0])
    av = np.ascontiguousarray(attrs, dtype=np.int32)
    dims = av.shape[1] if av.ndim == 2 else 1
    maxl = aps.num_detail_levels_minus1 + 1
    out_lcp = np.zeros(maxl + 1, dtype=np.int32)
    out_icp = np.zeros(3 * (maxl + 1), dtype=np.int32)
    recon = np.empty_like(av)
    cap = n * 16 + (1 << 16)
    buf = np.empty(cap, dtype=np.uint8)
    nb = lib.tmc13ref_encode_predlift(
        p32(pos32), n, p32(params), p32(periods), p32(qp_arr),
        p32(av.reshape(-1)),
        buf.ctypes.data_as(c.POINTER(c.c_uint8)), cap,
        p32(out_lcp), p32(out_icp), p32(recon.reshape(-1)))
    if nb < 0:
        raise RuntimeError(f"refpredlift encode rc={nb}")
    lcp = [int(v) for v in out_lcp[:maxl]]
    icp = [(0, int(out_icp[3 * l + 1]), int(out_icp[3 * l + 2]))
           for l in range(maxl)]
    return (buf[:nb].tobytes(), lcp, icp, recon,
            abh_stub.attr_dist2_delta)
